"""Port parity: the GCN and GAT variants' layers, dense forwards, weight
layouts and the banded GATv2 attention against the JAX package.

One graph shape: a random directed graph of 100 nodes and 400 edges
(mostly index-local, some far), padded by 12 nodes and 60 edges, as in
tests/test_sddmm.py.  Weights are drawn with numpy from a seed
(`init_model_numpy`) and reach JAX through models/convert.py; the JAX side
runs as its own CPU tests run it.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import build_model as jbuild, init_model as jinit
from gcn_grabcut_tpu.core.graph import stack_graphs as jstack
from gcn_grabcut_tpu.models import layers as jlayers
from gcn_grabcut_tpu.ops.sddmm import gat_plan_device as jplan
from gcn_grabcut_torch.core.graph import make_graph_batch
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models import layers as tlayers
from gcn_grabcut_torch.models.factory import (build_model, init_model,
                                              init_model_numpy)
from gcn_grabcut_torch.models.gat import GATTrimapNet
from gcn_grabcut_torch.models.gcn import GCNTrimapNet
from gcn_grabcut_torch.ops.region import segment_max
from gcn_grabcut_torch.ops.sddmm import gat_plan_device
from test_sddmm import _random_graph

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)     # one layer, fp32
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)     # a 2-layer model, fp32
BANDED_TOL = dict(rtol=2e-4, atol=2e-5)    # banded "highest" (JAX's bar)
DEFAULT_REL = 0.05                         # banded "default", of max|ref|
HEADS, FEATS, IN = 4, 8, 24


def graph(seed: int):
    return _random_graph(np.random.RandomState(seed), 100, 400,
                         n_pad_nodes=12, n_pad_edges=60)


def to_port(g):
    return make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)), device="cpu")


def edge_args(tg):
    return (tg.edge_src, tg.edge_dst, tg.edge_attr, tg.edge_mask,
            tg.node_mask)


def gat_layer(seed: int):
    """A port GATv2Conv with numpy-seeded weights, and its flax params."""
    layer = init_model_numpy(tlayers.GATv2Conv(IN, FEATS, heads=HEADS),
                             seed)
    sd = {k: v.numpy() for k, v in layer.state_dict().items()}
    params = {lin: {"kernel": sd[f"{lin}.weight"].T} for lin in
              ("lin_l", "lin_r", "lin_edge")}
    params["lin_l"]["bias"] = sd["lin_l.bias"]
    params["lin_r"]["bias"] = sd["lin_r.bias"]
    params.update(att=sd["att"], bias=sd["bias"])
    return layer, params


def features(g, seed: int):
    return np.random.RandomState(seed).randn(
        1, g.max_nodes, IN).astype(np.float32)


def valid(g):
    return np.asarray(g.node_mask) > 0


def test_gatv2conv_edge_list_matches_jax():
    g = graph(2)
    layer, params = gat_layer(0)
    x = features(g, 1)
    jout = jlayers.GATv2Conv(features=FEATS, heads=HEADS).apply(
        {"params": params}, x, g.edge_src, g.edge_dst, g.edge_attr,
        g.edge_mask, g.node_mask)
    with torch.no_grad():
        tout = layer(torch.from_numpy(x), *edge_args(to_port(g)))
    nm = valid(g)
    np.testing.assert_allclose(tout.numpy()[nm], np.asarray(jout)[nm],
                               **LAYER_TOL)


def test_edge_injection_matches_jax():
    g = graph(3)
    r = np.random.RandomState(4)
    updates = r.randn(1, g.max_nodes, 16).astype(np.float32)
    layer = init_model_numpy(tlayers.EdgeInjection(5, 16), 5)
    sd = {k: v.numpy() for k, v in layer.state_dict().items()}
    params = {f"Dense_{i}": {"kernel": sd[f"fc{i}.weight"].T,
                             "bias": sd[f"fc{i}.bias"]} for i in (0, 1)}
    jout = jlayers.EdgeInjection(16).apply(
        {"params": params}, g.edge_attr, g.edge_dst, g.edge_mask, updates)
    tg = to_port(g)
    with torch.no_grad():
        tout = layer(tg.edge_attr, tg.edge_dst, tg.edge_mask,
                     torch.from_numpy(updates))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LAYER_TOL)


@pytest.mark.parametrize("variant", ["gcn", "gat"])
def test_dense_forward_matches_jax(variant):
    """Eval mode, hidden 32, 2 layers, G = 2 padded graphs."""
    gb = jstack([graph(5), graph(6)])
    model = init_model_numpy(build_model(variant, hidden_channels=32,
                                         n_layers=2), 7)
    jm = jbuild(variant, hidden_channels=32, n_layers=2)
    vs = convert.jax_variables_from_state_dict(model.state_dict())
    jout = np.asarray(jm.apply(vs, gb, train=False))
    with torch.no_grad():
        tout = model(to_port(gb)).numpy()
    nm = valid(gb)
    np.testing.assert_allclose(tout[nm], jout[nm], **MODEL_TOL)


@pytest.mark.parametrize("variant, hidden, n_layers",
                         [("gcn", 32, 2), ("gat", 32, 2), ("gcn", 128, 6),
                          ("gat", 128, 6)])
def test_weight_layout_matches_jax_init_tree(variant, hidden, n_layers):
    """Every flax name, shape and batch statistic of JAX's init_model tree
    maps to a port tensor and back, leaf for leaf."""
    g = graph(0)
    jm = jbuild(variant, hidden_channels=hidden, n_layers=n_layers)
    vs = jax.tree_util.tree_map(np.asarray, jinit(jm, jr.PRNGKey(0), g))
    model = build_model(variant, hidden_channels=hidden, n_layers=n_layers)
    back = convert.jax_variables_from_state_dict(model.state_dict())
    assert (jax.tree_util.tree_map(np.shape, back)
            == jax.tree_util.tree_map(np.shape, vs))
    sd = convert.state_dict_from_jax(vs)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    again = convert.jax_variables_from_state_dict(model.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(vs)
    flat_again = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(flat) == len(flat_again)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_again[path], leaf)
    rebuilt = convert.model_from_jax(vs)
    assert isinstance(rebuilt, {"gcn": GCNTrimapNet,
                                "gat": GATTrimapNet}[variant])


def test_build_model_variants_and_init():
    gat = build_model("gat")
    assert isinstance(gat, GATTrimapNet) and len(gat.convs) == 6
    assert gat.convs[0].heads == 8 and gat.convs[0].features == 16
    assert isinstance(build_model("gcn"), GCNTrimapNet)
    with pytest.raises(ValueError, match="Unknown variant"):
        build_model("sage")
    init_model(gat, 3)
    att = torch.cat([c.att.detach().reshape(-1) for c in gat.convs])
    # flax's Kaiming normal of an (H, F) kernel: fan-in H = 8.
    assert abs(float(att.pow(2).mean()) / (2.0 / 8) - 1.0) < 0.15
    assert all(float(c.bias.detach().abs().max()) == 0.0 for c in gat.convs)


def test_segment_max_gives_minus_inf_on_empty_segments():
    idx = torch.tensor([0, 0, 2])
    out = segment_max(idx, torch.tensor([[1.0], [3.0], [-2.0]]), 4)
    assert out[:, 0].tolist() == [3.0, float("-inf"), -2.0, float("-inf")]


@pytest.mark.parametrize("window", [32, 64])
def test_gat_plan_matches_jax_exactly(window):
    g = graph(2)
    tg = to_port(g)
    jp = jplan(g.edge_src[0], g.edge_dst[0], g.edge_attr[0], g.edge_mask[0],
               g.max_nodes, block_rows=16, window=window)
    tp = gat_plan_device(tg.edge_src[0], tg.edge_dst[0], tg.edge_attr[0],
                         tg.edge_mask[0], g.max_nodes, block_rows=16,
                         window=window)
    assert (tp.n_nodes, tp.block_rows, tp.k_blocks) == (
        jp.n_nodes, jp.block_rows, jp.k_blocks)
    for f in ("attr_band", "mask_band", "fb_src", "fb_dst", "fb_attr",
              "fb_mask", "attr_mean", "fb_overflow"):
        want = np.asarray(getattr(jp, f))
        got = getattr(tp, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    assert int(tp.fb_overflow[0]) == 0


@pytest.mark.parametrize("window", [32, 64])
def test_banded_attention_matches_jax_and_edge_list(window):
    g = graph(2)
    tg = to_port(g)
    layer, params = gat_layer(8)
    x = features(g, 9)
    jl = jlayers.GATv2Conv(features=FEATS, heads=HEADS)
    jargs = (x, g.edge_src, g.edge_dst, g.edge_attr, g.edge_mask,
             g.node_mask)
    jp = jplan(g.edge_src[0], g.edge_dst[0], g.edge_attr[0], g.edge_mask[0],
               g.max_nodes, block_rows=16, window=window)
    jband = np.asarray(jl.apply({"params": params}, *jargs, plan=jp,
                                plan_precision="highest"))
    tp = gat_plan_device(tg.edge_src[0], tg.edge_dst[0], tg.edge_attr[0],
                         tg.edge_mask[0], g.max_nodes, block_rows=16,
                         window=window)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        edge_list = layer(xt, *edge_args(tg)).numpy()
        highest = layer(xt, *edge_args(tg), plan=tp,
                        plan_precision="highest").numpy()
        default = layer(xt, *edge_args(tg), plan=tp).numpy()
    nm = valid(g)
    np.testing.assert_allclose(highest[nm], jband[nm], **BANDED_TOL)
    np.testing.assert_allclose(highest[nm], edge_list[nm], **BANDED_TOL)
    scale = np.abs(edge_list[nm]).max()
    assert np.abs(default[nm] - edge_list[nm]).max() < DEFAULT_REL * scale
    # JAX's "default" is held to the same bar against the same reference.
    jdefault = np.asarray(jl.apply({"params": params}, *jargs, plan=jp))
    assert np.abs(default[nm] - jdefault[nm]).max() < DEFAULT_REL * scale


def test_repeated_edges_keep_their_own_softmax_slots():
    """A graph whose edge list repeats in-window edges (the graph build
    gives such above 2048 nodes): the port's banded form still equals the
    edge list, the repeats in the fallback list; the JAX package's plan
    adds a repeat into its edge's slot and departs from its edge list."""
    g = graph(2)
    em = np.asarray(g.edge_mask[0]) > 0
    src, dst = np.array(g.edge_src[0]), np.array(g.edge_dst[0])
    attr, mask = np.array(g.edge_attr[0]), np.array(g.edge_mask[0])
    local = np.nonzero(em & (np.abs(src - dst) < 8))[0][:20]
    pad = np.nonzero(~em)[0][:20]
    src[pad], dst[pad], mask[pad] = src[local], dst[local], 1.0
    attr[pad] = np.random.RandomState(10).rand(20, 5).astype(np.float32)
    g = g.replace(edge_src=src[None], edge_dst=dst[None],
                  edge_attr=attr[None], edge_mask=mask[None])
    tg = to_port(g)
    layer, params = gat_layer(11)
    x = features(g, 12)
    xt = torch.from_numpy(x)
    tp = gat_plan_device(tg.edge_src[0], tg.edge_dst[0], tg.edge_attr[0],
                         tg.edge_mask[0], g.max_nodes, block_rows=16,
                         window=64)
    assert float(tp.mask_band.max()) == 1.0
    assert float(tp.mask_band.sum() + tp.fb_mask.sum()) == float(mask.sum())
    with torch.no_grad():
        edge_list = layer(xt, *edge_args(tg)).numpy()
        banded = layer(xt, *edge_args(tg), plan=tp,
                       plan_precision="highest").numpy()
    nm = valid(g)
    np.testing.assert_allclose(banded[nm], edge_list[nm], **BANDED_TOL)
    jl = jlayers.GATv2Conv(features=FEATS, heads=HEADS)
    jargs = (x, g.edge_src, g.edge_dst, g.edge_attr, g.edge_mask,
             g.node_mask)
    jp = jplan(g.edge_src[0], g.edge_dst[0], g.edge_attr[0], g.edge_mask[0],
               g.max_nodes, block_rows=16, window=64)
    jband = np.asarray(jl.apply({"params": params}, *jargs, plan=jp,
                                plan_precision="highest"))
    jedge = np.asarray(jl.apply({"params": params}, *jargs))
    np.testing.assert_allclose(edge_list[nm], jedge[nm], **LAYER_TOL)
    assert float(np.asarray(jp.mask_band).max()) == 2.0
    assert np.abs(jband[nm] - jedge[nm]).max() > 100 * BANDED_TOL["atol"]
