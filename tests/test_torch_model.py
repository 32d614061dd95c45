"""Port parity: ResGCNNet through the banded-SpMM large path, and the
weight converter, against the JAX package.

Weights come from the JAX package's own `init_model` (perturbed so no
parameter sits at its trivial init value) and are converted to the port.
The JAX forward runs `apply_large(..., interpret=True)`, exact fp32; the
port runs its plain path on the CPU at precision="highest".
"""

import numpy as np
import pytest
import torch
import jax
import jax.random as jr

from gcn_grabcut_tpu import build_model, init_model
from gcn_grabcut_tpu.core.graph import single_graph
from gcn_grabcut_tpu.models.large import apply_large as japply_large
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models.large import apply_large
from gcn_grabcut_torch.models.resgcn import ResGCNNet

torch.set_num_threads(1)

ATOL = 1e-4


def banded_graph(n=400, pad_nodes=20, seed=0):
    """Symmetric near-diagonal edges plus a few far (fallback) edges, with
    padded node and edge slots."""
    r = np.random.RandomState(seed)
    x = r.randn(n, 19).astype(np.float32)
    src_l = r.randint(0, n, 2000)
    dst_l = np.clip(src_l + r.randint(-200, 200, 2000), 0, n - 1)
    keep = src_l != dst_l
    far = r.randint(0, n, (2, 40))
    src = np.concatenate([src_l[keep], dst_l[keep], far[0]])
    dst = np.concatenate([dst_l[keep], src_l[keep], far[1]])
    attr = r.rand(len(src), 5).astype(np.float32)
    return single_graph(x, src, dst, attr, max_nodes=n + pad_nodes,
                        max_edges=len(src) + 30)


def jax_variables(g, hidden=16, n_layers=2, seed=0):
    m = build_model("resgcn", hidden_channels=hidden, n_layers=n_layers)
    vs = init_model(m, jr.PRNGKey(seed), g)
    r = np.random.RandomState(seed + 1)
    vs = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.randn(*np.shape(a))).astype(
            np.float32), vs)
    vs["batch_stats"]["in_norm"]["var"] = (
        np.abs(vs["batch_stats"]["in_norm"]["var"]) + 0.5)
    return m, vs


def to_port(g):
    return make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_large_matches_jax(seed):
    g = banded_graph(seed=seed)
    m, vs = jax_variables(g, seed=seed)
    jout = np.asarray(japply_large(m, vs, g, interpret=True))[0]
    model = convert.resgcn_from_jax(vs)
    tout = apply_large(model, to_port(g), precision="highest",
                       device="cpu").numpy()[0]
    valid = np.asarray(g.node_mask[0]) > 0
    np.testing.assert_allclose(tout[valid], jout[valid], atol=ATOL)


def test_ensemble_on_the_large_path_matches_jax(monkeypatch):
    """Two members through the large path: the JAX pipeline's
    `_apply_large_any` (one apply_large per member, mean probability,
    log'd; its Pallas SpMM interpreted) against the port's ensemble,
    whose members share one pair of SpMM plans."""
    import functools
    from gcn_grabcut_tpu import pipeline as jpipeline
    from gcn_grabcut_tpu.models import large as jlarge
    from gcn_grabcut_tpu.models.factory import stack_variables
    from gcn_grabcut_torch.models.factory import ResGCNEnsemble
    monkeypatch.setattr(jlarge, "apply_large",
                        functools.partial(japply_large, interpret=True))
    g = banded_graph(seed=3)
    members = [jax_variables(g, seed=s) for s in (3, 4)]
    jout = jpipeline._apply_large_any(
        members[0][0], stack_variables([v for _, v in members]), g)
    ensemble = ResGCNEnsemble([convert.resgcn_from_jax(v)
                               for _, v in members])
    tout = apply_large(ensemble, to_port(g), precision="highest",
                       device="cpu")
    valid = np.asarray(g.node_mask[0]) > 0
    np.testing.assert_allclose(torch.softmax(tout, -1).numpy()[0][valid],
                               np.asarray(jax.nn.softmax(jout, -1))[0][valid],
                               atol=1e-5)


def test_bf16_forward_stays_near_fp32():
    g = banded_graph(seed=2)
    _, vs = jax_variables(g, seed=2)
    model = convert.resgcn_from_jax(vs)
    tg = to_port(g)
    exact = apply_large(model, tg, precision="highest", device="cpu")
    bf16 = apply_large(model, tg, device="cpu")
    scale = float(exact.abs().max())
    assert float((bf16 - exact).abs().max()) / scale < 2e-2


def test_converter_round_trips_every_leaf():
    g = banded_graph()
    _, vs = jax_variables(g)
    back = convert.jax_variables_from_state_dict(
        convert.state_dict_from_jax(vs))
    flat_a = jax.tree_util.tree_leaves_with_path(vs)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("hidden,n_layers", [(16, 2), (128, 6)])
def test_parameter_count_matches_jax(hidden, n_layers):
    g = banded_graph(n=50, pad_nodes=0)
    m = build_model("resgcn", hidden_channels=hidden, n_layers=n_layers)
    vs = init_model(m, jr.PRNGKey(0), g)
    jcount = sum(np.size(a) for a in
                 jax.tree_util.tree_leaves(vs["params"]))
    port = ResGCNNet(hidden_channels=hidden, n_layers=n_layers)
    assert sum(p.numel() for p in port.parameters()) == jcount
    if (hidden, n_layers) == (128, 6):
        assert jcount == 187_826
    # The port's own state_dict converts to a JAX tree of the same shapes.
    back = convert.jax_variables_from_state_dict(port.state_dict())
    shapes = jax.tree_util.tree_map(np.shape, vs)
    assert jax.tree_util.tree_map(np.shape, back) == shapes


def test_seeded_init_is_reproducible():
    def make(seed):
        return ResGCNNet(hidden_channels=16, n_layers=2,
                         generator=torch.Generator().manual_seed(seed))
    a, b, c = make(3), make(3), make(4)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb)
    assert not torch.equal(a.input_proj.weight, c.input_proj.weight)


def test_apply_large_needs_cuda_unless_cpu_is_asked():
    g = to_port(banded_graph(n=100, pad_nodes=0))
    model = ResGCNNet(hidden_channels=16, n_layers=2)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="graph is on"):
            apply_large(model, g)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            apply_large(model, g)
