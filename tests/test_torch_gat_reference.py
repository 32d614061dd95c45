"""GATTrimapNet in the port against the benchmark's plain reference
(``bench_port/reference/plain/models/gat.py``: plain torch over one
graph's edge list, imported here as the benchmark imports it), on weights
drawn from a seed; the trained checkpoint the benchmark's GAT cell reads
and its recipe; and the reference's imports.

Each comparison reads the largest gap of a valid node's logit over the
reference's largest logit magnitude.  Tolerances, with their reasons:

* float32 (the edge-list forward, the banded attention at "highest"):
  `F32_TOL` 1e-5.  Both sides compute the same float32 function in other
  orders of adds; they meet to ~3e-7.
* bfloat16 (the banded attention at its "default" precision, against
  the reference rounded at the same points): `BF16_TOL` 4e-3.  The port
  rounds z after each of its two adds, in an order that differs between
  its window and its fallback list, and the reference rounds the float32
  sum once, so z can differ by one bfloat16 step (2^-8 of it) on any
  edge; over 2-6 layers that leaves gaps of 5e-4 to 1.0e-3.  The
  control (the reference with float8 e4m3 at the attention's rounding
  points and the Linears and norms in bfloat16, what the benchmark's
  control computes) lies 9e-3 to 1.8e-2 away, so each test also asserts
  that it fails the tolerance.
"""

import importlib.util
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import gcn_grabcut_torch as gt
from gcn_grabcut_torch.models.factory import init_model_numpy
from gcn_grabcut_torch.models.gat import GATTrimapNet
from gcn_grabcut_torch.models.large import apply_large
from gcn_grabcut_torch.ops.sddmm import gat_plan_device
from test_sddmm import _random_graph

from bench_port import harness
from bench_port.reference.plain.models import gat as plain_gat

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 4e-3
HW, N_SEGMENTS = 224, 2600
LOWER = dict(attention_dtype=torch.float8_e4m3fn,
             compute_dtype=torch.bfloat16)


def to_port(g):
    return gt.make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)), device="cpu")


def random_graph():
    """test_sddmm's 120-node graph with padded nodes and edges."""
    return to_port(_random_graph(np.random.RandomState(3), 120, 500,
                                 n_pad_nodes=8, n_pad_edges=50))


def small_plan(g):
    """The graph's plan in blocks of 16 rows and a window of 32, so that
    many edges take the fallback list."""
    plan = gat_plan_device(g.edge_src[0], g.edge_dst[0], g.edge_attr[0],
                           g.edge_mask[0], g.max_nodes, block_rows=16,
                           window=32)
    assert 0 < float(plan.fb_mask.sum()) < float(plan.mask_band.sum())
    return plan


def seeded(hidden: int, heads: int, n_layers: int, seed: int = 11):
    model = init_model_numpy(GATTrimapNet(hidden_channels=hidden,
                                          n_heads=heads, n_layers=n_layers),
                             seed)
    return model, plain_gat.GATTrimapNet(model.state_dict())


def reference(ref, g, **precision):
    return ref(g.x[0], g.edge_src[0], g.edge_dst[0], g.edge_attr[0],
               g.node_mask[0], g.edge_mask[0], **precision)


def gap(out, ref, g) -> float:
    nm = g.node_mask[0] > 0
    return float((out[nm].float() - ref[nm]).abs().max()
                 / ref[nm].abs().max())


@pytest.fixture(scope="module")
def slic_graph():
    r = np.random.RandomState(7)
    img = np.kron(r.rand(HW // 8, HW // 8, 3), np.ones((8, 8, 1)))
    noise = np.random.RandomState(1007).randint(-12, 13, (HW, HW, 3))
    img = np.clip((img * 255).astype(np.uint8) + noise, 0, 255)
    tg = gt.build_graph(img.astype(np.uint8),
                        gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS),
                        device="cpu")
    assert tg.n_nodes > gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD
    return tg.graph


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("graph", ["random", "slic"])
def test_banded_attention_matches_the_reference(graph, precision, request):
    """D=32, 4 heads, 2 layers through apply_large: on the random graph
    with a small plan, and on a 224² / 2600-superpixel SLIC graph (the
    build's own edges: adjacency and non-local pairs, repeats included)
    at the large path's default plan."""
    model, ref = seeded(32, 4, 2, seed=11 if graph == "random" else 12)
    if graph == "random":
        g = random_graph()
        out = apply_large(model, g, plans=small_plan(g),
                          precision=precision, device="cpu")[0]
    else:
        g = request.getfixturevalue("slic_graph")
        out = apply_large(model, g, precision=precision, device="cpu")[0]
    if precision == "highest":
        assert gap(out, reference(ref, g), g) < F32_TOL
        with torch.no_grad():
            assert gap(model(g)[0], reference(ref, g), g) < F32_TOL
    else:
        want = reference(ref, g, attention_dtype=torch.bfloat16)
        assert gap(out, want, g) < BF16_TOL
        assert gap(reference(ref, g, **LOWER), want, g) > BF16_TOL


def test_whole_forward_at_the_configuration_widths():
    """D=128, 8 heads of 16, 6 layers (the GAT cell's model) on the
    random graph: the edge-list forward in float32 and the banded
    attention at its default precision."""
    g = random_graph()
    model, ref = seeded(128, 8, 6)
    with torch.no_grad():
        assert gap(model(g)[0], reference(ref, g), g) < F32_TOL
    out = apply_large(model, g, plans=small_plan(g), device="cpu")[0]
    want = reference(ref, g, attention_dtype=torch.bfloat16)
    assert gap(out, want, g) < BF16_TOL
    assert gap(reference(ref, g, **LOWER), want, g) > BF16_TOL


def load_trainer():
    path = harness.HERE / "weights" / "trained.py"
    spec = importlib.util.spec_from_file_location("bench_trained", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(load_trainer().RECIPES))
def test_trained_checkpoint_records_its_recipe(name):
    """The committed checkpoint is what its recipe's `cli.train` run kept:
    the best validation epoch of the recorded command, with its history
    beside it, and the model the recipe names."""
    trainer = load_trainer()
    committed = harness.HERE / "weights" / name
    model, meta = gt.load_model_auto(str(committed), device="cpu")
    recipe = trainer.RECIPES[name]
    assert meta["recipe"] == trainer.command(recipe)
    assert meta["variant"] == recipe[recipe.index("--model") + 1] == "gat"
    assert isinstance(model, GATTrimapNet)
    assert model.n_layers == int(recipe[recipe.index("--layers") + 1])
    assert meta["config"]["seed"] == int(recipe[recipe.index("--seed") + 1])
    history = json.loads(committed.with_suffix(".history.json").read_text())
    assert meta["score"] == max(history["val_score"])


def test_the_recipe_writes_the_best_epoch_without_optimiser_state(tmp_path):
    """`trained.write` at a tiny size on the CPU: the file holds the best
    epoch's weights and the recipe, and no optimiser state."""
    from gcn_grabcut_torch.train.checkpoints import load_opt_state
    torch.set_num_threads(2)
    recipe = ["--model", "gat", "--hidden", "16", "--layers", "2",
              "--hard-synthetic", "12", "--hard-size", "128",
              "--n-segments", "100", "--epochs", "2", "--batch", "4",
              "--seed", "3"]
    path = tmp_path / "tiny.msgpack"
    meta = load_trainer().write(path, recipe, ["--cpu"])
    assert meta["recipe"].endswith(" ".join(recipe))
    assert "--cpu" not in meta["recipe"]
    assert load_opt_state(path) is None
    model, read = gt.load_model_auto(str(path), device="cpu")
    assert isinstance(model, GATTrimapNet)
    assert read == dict(meta, ensemble_size=1)
    history = json.loads(path.with_suffix(".history.json").read_text())
    assert meta["score"] == max(history["val_score"])


PROBE = """
import sys
sys.path.insert(0, {root!r})
import torch
from bench_port.reference import gat_pipeline
from bench_port.reference.plain.models import gat, gat_weights
model, meta = gat_weights.load({ckpt!r}, "cpu")
g = torch.Generator().manual_seed(0)
x = torch.randn(6, 19, generator=g)
src, dst = torch.tensor([0, 1, 2, 3]), torch.tensor([1, 2, 3, 4])
out = model(x, src, dst, torch.rand(4, 5, generator=g), torch.ones(6),
            torch.ones(4), attention_dtype=torch.bfloat16)
assert out.shape == (6, 3) and bool(torch.isfinite(out).all())
print(sorted(m for m in sys.modules if m.split(".")[0] in
             ("gcn_grabcut_torch", "jax", "jaxlib", "flax",
              "gcn_grabcut_tpu")))
"""


def test_reference_loads_nothing_of_the_port_or_jax():
    cell = harness.load_cell("large1536_gat.stream1", 1, 1.0, False)
    ckpt = str(harness.ROOT / cell.config["checkpoints"][0])
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                            ckpt=ckpt)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
