"""The banded attention's spans and counter on the CPU: under a torch
profiler GATTrimapNet's large forward opens `layer.forward.plan` once and
`layer.forward.attention` once a layer, inside `layer.forward`; without
one it enters no record_function; ``ops.sddmm.counts`` records a plan's
edges and each call's shape only while a profiler records (or after
`reset()`); a ResGCNNet large forward opens neither span."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gcn_grabcut_torch as gt
from gcn_grabcut_torch import utils
from gcn_grabcut_torch.models.factory import build_model, init_model_numpy
from gcn_grabcut_torch.models.gat import GATTrimapNet
from gcn_grabcut_torch.models.large import apply_large, build_gat_plan_device
from gcn_grabcut_torch.ops import sddmm
from test_sddmm import _random_graph

torch.set_num_threads(1)

N_LAYERS = 2
NEW_SPANS = ("layer.forward.plan", "layer.forward.attention")


@pytest.fixture(scope="module")
def graph():
    """A 1200-node graph: its plan (blocks of 128, window 512) leaves the
    far edges to the fallback list."""
    g = _random_graph(np.random.RandomState(5), 1200, 6000, n_pad_nodes=8,
                      n_pad_edges=40)
    return gt.make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)), device="cpu")


@pytest.fixture(scope="module")
def gat():
    return init_model_numpy(GATTrimapNet(hidden_channels=16, n_heads=4,
                                         n_layers=N_LAYERS), 3)


@pytest.fixture
def counts(monkeypatch):
    fresh = sddmm.AttentionCounts()
    monkeypatch.setattr(sddmm, "counts", fresh)
    return fresh


def spans_of(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("layer.")]


def plan_args(g):
    return (g.edge_src[0], g.edge_dst[0], g.edge_attr[0], g.edge_mask[0],
            g.max_nodes)


def test_gat_forward_opens_its_spans_inside_the_forward(graph, gat,
                                                        counts):
    pipe = gt.GCNGrabCutPipeline(gat, device="cpu")
    pipe.LARGE_NODE_THRESHOLD = 64          # the large path at 1208 nodes
    plain = pipe._predict_probs_batch(graph)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipe._predict_probs_batch(graph)
    assert torch.equal(plain, traced)
    spans = spans_of(prof)
    names = [name for name, _, _ in spans]
    assert names.count("layer.forward.plan") == 1
    assert names.count("layer.forward.attention") == N_LAYERS
    (fs, fe), = [(s, e) for name, s, e in spans if name == "layer.forward"]
    inner = sorted((s, e) for name, s, e in spans if name in NEW_SPANS)
    assert all(fs <= s and e <= fe for s, e in inner)
    assert all(e <= s for (_, e), (s, _) in zip(inner, inner[1:]))
    assert len(counts.plans) == 1 and len(counts.calls) == N_LAYERS


def test_no_span_or_count_without_a_profiler(graph, gat, counts,
                                             monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(utils, "record_function", refuse)
    apply_large(gat, graph, device="cpu")
    assert counts.plans == [] and counts.calls == []


def test_counts_hold_the_plans_edges_and_the_calls_shapes(graph, gat,
                                                          counts):
    with profile(activities=[ProfilerActivity.CPU]):
        plan = build_gat_plan_device(*plan_args(graph))
        apply_large(gat, graph, plans=plan, device="cpu")
    (rec,) = counts.plans
    assert rec == dict(nodes=graph.max_nodes, rebuilt=False,
                       in_window=int(plan.mask_band.sum()),
                       fallback=int(plan.fb_mask.sum()), dropped=0)
    assert rec["fallback"] > 0
    assert rec["in_window"] + rec["fallback"] == int(graph.edge_mask.sum())
    Np, K, R = plan.n_nodes, plan.k_blocks, plan.block_rows
    assert counts.calls == [(Np, K, R, 4, 4, plan.fb_src.shape[0])] \
        * N_LAYERS
    totals = counts.totals()
    assert totals["plans"] == 1 and totals["calls"] == N_LAYERS
    assert totals["fallback"] == rec["fallback"]


def test_reset_records_without_a_profiler(graph, counts):
    counts.reset()
    build_gat_plan_device(*plan_args(graph))
    assert len(counts.plans) == 1
    counts.clear()
    assert counts.plans == [] and counts.recording


def test_a_rebuilt_plan_counts_the_edges_it_dropped(counts):
    """All-far edges overflow the default fallback capacity: the plan is
    rebuilt exact, and the counter keeps the first build's drop."""
    g = _random_graph(np.random.RandomState(7), 1200, 12000, local_frac=0.0)
    g = gt.make_graph_batch(*(np.array(a) for a in (
        g.x, g.edge_src, g.edge_dst, g.edge_attr, g.node_mask, g.edge_mask,
        g.node_area)), device="cpu")
    counts.reset()
    with pytest.warns(RuntimeWarning, match="fallback capacity"):
        plan = build_gat_plan_device(*plan_args(g), window=64)
    (rec,) = counts.plans
    assert rec["rebuilt"] and rec["dropped"] > 0
    assert rec["fallback"] == int(plan.fb_mask.sum())


def test_resgcn_large_forward_opens_neither_span(graph, counts):
    model = init_model_numpy(build_model("resgcn", hidden_channels=16,
                                         n_layers=2), 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply_large(model, graph, window=64, device="cpu")
    assert not set(NEW_SPANS) & {name for name, _, _ in spans_of(prof)}
    assert counts.plans == [] and counts.calls == []


def test_profile_trace_writes_the_attention_counts(graph, gat, counts,
                                                   tmp_path):
    counts.reset()
    build_gat_plan_device(*plan_args(graph))        # cleared on entry
    with utils.profile_trace(tmp_path):
        apply_large(gat, graph, device="cpu")
    (path,) = tmp_path.glob("*.attention.json")
    got = json.loads(path.read_text())
    assert got["plans"] == 1 and got["calls"] == N_LAYERS
    assert got["rebuilt"] == got["dropped"] == 0
