"""Port parity on the large-graph path for the GCN and GAT variants:
`apply_large` (GCNTrimapNet through the banded SpMM's plain version,
GATTrimapNet through the banded attention), the GAT plan's overflow
guard, the pipeline's routing above LARGE_NODE_THRESHOLD, and
`predict_probs(RegionGraph)` at 224² / 2600 superpixels, against the JAX
package on the CPU.

Shapes: a random 120-node graph (the JAX package's test_sddmm.py one) for
`apply_large`, a 1200-node all-far graph for the overflow guard, and the
SLIC graph of a noise-textured 224² image for the rest.  Weights come
from numpy (`init_model_numpy`) through models/convert.py.
"""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcn_grabcut_tpu as jgt
from gcn_grabcut_tpu import pipeline as jpipeline
from gcn_grabcut_tpu.models import large as jlarge
from gcn_grabcut_tpu.models.factory import stack_variables
import gcn_grabcut_torch as gt
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models.factory import (ModelEnsemble, build_model,
                                              init_model_numpy)
from gcn_grabcut_torch.models.large import apply_large, build_gat_plan_device
from gcn_grabcut_torch.ops.sddmm import gat_plan_device
from test_sddmm import _random_graph

torch.set_num_threads(1)

HIGHEST_TOL = dict(rtol=2e-4, atol=2e-4)   # GAT at "highest" (test_sddmm)
SPMM_TOL = dict(rtol=2e-3, atol=2e-3)      # GCN SpMM (test_large_graph)
DEFAULT_REL = 0.05                         # "default", of max|ref|
PROBS_TOL = 2e-2                           # bf16 large path, posteriors
HW, N_SEGMENTS = 224, 2600


def to_port(g):
    return gt.make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)), device="cpu")


def models(variant: str, seed: int, hidden: int = 16, n_layers: int = 2):
    """(port model, JAX module, JAX variables) with the same weights."""
    model = init_model_numpy(build_model(variant, hidden_channels=hidden,
                                         n_layers=n_layers), seed)
    vs = convert.jax_variables_from_state_dict(model.state_dict())
    return model, jgt.build_model(variant, hidden_channels=hidden,
                                  n_layers=n_layers), vs


def noise_image(seed: int) -> np.ndarray:
    """Blocky noise with a brighter disc and +-12 pixel noise."""
    r = np.random.RandomState(seed)
    img = np.kron(r.rand(HW // 8, HW // 8, 3), np.ones((8, 8, 1)))
    yy, xx = np.mgrid[0:HW, 0:HW]
    blob = ((yy - HW // 2) ** 2 + (xx - int(HW * 0.47)) ** 2) < (HW // 4) ** 2
    img[blob] = img[blob] * 0.25 + r.rand(3) * 0.75
    noise = np.random.RandomState(1000 + seed).randint(-12, 13, (HW, HW, 3))
    return np.clip((img * 255).astype(np.uint8) + noise, 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def slic_graphs():
    img = noise_image(7)
    cfg = dict(n_segments=N_SEGMENTS)
    jg = jgt.build_graph(img, jgt.SuperpixelGraphConfig(**cfg))
    tg = gt.build_graph(img, gt.SuperpixelGraphConfig(**cfg), device="cpu")
    assert tg.n_nodes > gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD
    np.testing.assert_array_equal(tg.segments, np.asarray(jg.segments))
    return jg, tg


def valid(g):
    return np.asarray(g.node_mask) > 0


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_apply_large_matches_jax(variant):
    g = _random_graph(np.random.RandomState(3), 120, 500, n_pad_nodes=8,
                      n_pad_edges=50)
    model, jm, vs = models(variant, 11, hidden=32)
    tg = to_port(g)
    nm = valid(g)
    with torch.no_grad():
        dense = model(tg).numpy()
    if variant == "gat":
        jout = np.asarray(jlarge.apply_large(jm, vs, g, window=64,
                                             precision="highest"))
        tol = HIGHEST_TOL
    else:   # the JAX SpMM's exact fp32 oracle
        jout = np.asarray(jlarge.apply_large(jm, vs, g, window=64,
                                             interpret=True))
        tol = SPMM_TOL
    out = apply_large(model, tg, window=64, precision="highest",
                      device="cpu").numpy()
    np.testing.assert_allclose(out[nm], jout[nm], **tol)
    np.testing.assert_allclose(out[nm], dense[nm], **tol)
    default = apply_large(model, tg, window=64, device="cpu").numpy()
    scale = np.abs(dense[nm]).max()
    assert np.abs(default[nm] - dense[nm]).max() < DEFAULT_REL * scale


def test_gat_ensemble_on_the_large_path_matches_jax():
    """Two GAT members: JAX's `_apply_large_any` (one apply_large per
    member, mean probability, log'd) against the port's ensemble, whose
    members share one plan."""
    g = _random_graph(np.random.RandomState(4), 120, 500)
    members = [models("gat", s) for s in (12, 13)]
    jl = functools.partial(jlarge.apply_large, precision="highest")
    orig = jlarge.apply_large
    jlarge.apply_large = jl
    try:
        jout = np.asarray(jpipeline._apply_large_any(
            members[0][1], stack_variables([v for _, _, v in members]), g))
    finally:
        jlarge.apply_large = orig
    ens = ModelEnsemble([m for m, _, _ in members])
    assert ens.supports_banded_attention
    assert not ens.supports_spmm_aggregators
    out = apply_large(ens, to_port(g), precision="highest",
                      device="cpu").numpy()
    nm = valid(g)
    np.testing.assert_allclose(out[nm], jout[nm], **HIGHEST_TOL)


def test_overflowing_plan_warns_and_rebuilds_exact():
    """All-far edges overflow the default capacity E//2 + 4096: the plan is
    rebuilt at capacity E with a warning, and equals the exact plan."""
    g = _random_graph(np.random.RandomState(7), 1200, 12000, local_frac=0.0)
    tg = to_port(g)
    args = (tg.edge_src[0], tg.edge_dst[0], tg.edge_attr[0], tg.edge_mask[0],
            tg.max_nodes)
    small = gat_plan_device(*args, window=64, fb_capacity=12000 // 2 + 4096)
    assert int(small.fb_overflow[0]) > 0
    with pytest.warns(RuntimeWarning, match="fallback capacity"):
        plan = build_gat_plan_device(*args, window=64)
    assert int(plan.fb_overflow[0]) == 0
    exact = gat_plan_device(*args, window=64, fb_capacity=12000)
    for f in ("fb_src", "fb_dst", "fb_attr", "fb_mask", "attr_band"):
        assert torch.equal(getattr(plan, f), getattr(exact, f)), f
    model, _, _ = models("gat", 14, n_layers=1)
    got = apply_large(model, tg, window=64, plans=plan, precision="highest",
                      device="cpu").numpy()
    with torch.no_grad():
        ref = model(tg).numpy()
    nm = valid(g)
    np.testing.assert_allclose(got[nm], ref[nm], **HIGHEST_TOL)


def test_slic_graph_does_not_warn(slic_graphs):
    _, tg = slic_graphs
    g = tg.graph
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        plan = build_gat_plan_device(g.edge_src[0], g.edge_dst[0],
                                     g.edge_attr[0], g.edge_mask[0],
                                     g.max_nodes)
    assert int(plan.fb_overflow[0]) == 0


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_predict_probs_matches_jax_above_threshold(slic_graphs, variant):
    """The whole slice on the CPU: predict_probs(RegionGraph) through the
    large path (banded SpMM or banded attention, both "default", bf16)."""
    jg, tg = slic_graphs
    model, jm, vs = models(variant, 21)
    jprobs = jgt.GCNGrabCutPipeline(jm, vs).predict_probs(jg)
    pipe = gt.GCNGrabCutPipeline(model, device="cpu")
    probs = pipe.predict_probs(tg)
    assert probs.shape == (tg.n_nodes, 3) and np.isfinite(probs).all()
    nm = valid(tg.graph)[0]
    assert np.abs(probs - jprobs)[nm].max() < PROBS_TOL


class _Stub(torch.nn.Module):
    """A model with neither large-path attribute: logits from x."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(19, 3)
        self.calls = []

    def forward(self, g, **kwargs):
        self.calls.append(kwargs)
        return self.proj(g.x)


def test_model_without_a_large_path_takes_the_dense_forward(slic_graphs):
    """Above the threshold a model with neither attribute runs its dense
    forward (JAX pipeline.py:594-603); apply_large raises ValueError with
    JAX's message."""
    _, tg = slic_graphs
    stub = _Stub()
    probs = gt.GCNGrabCutPipeline(stub, device="cpu").predict_probs(tg)
    assert probs.shape == (tg.n_nodes, 3) and stub.calls == [{}]
    with pytest.raises(ValueError, match="has no large-graph forward"):
        apply_large(stub, tg.graph, device="cpu")
