"""The GAT configuration's pieces: its four readers on hand-built records
(None where the program keeps no such span or counter), the FLOP and byte
counts against hand counts on a tiny graph, the cell's files found by
name, its checkpoint as the reference reads it, and on the CPU at a tiny
size a run of the cell's driver, sound and with the control."""

import sys
import types

import pytest
import torch

from bench_port import harness
from bench_port.count import attention_bytes, gat_flops
from bench_port.trace import WINDOW_SPAN, Trace

MS = 1_000_000   # ns
CELL = "large1536_gat.stream1"
SDDMM = "gcn_grabcut_torch.ops.sddmm"
NEW = ("attention_device_ms", "gat_plan_device_ms", "attention_roofline",
       "gat_fallback_edges_per_image")


def traced() -> Trace:
    """A 50 ms forward on thread 1: the plan 1-5 ms (kernel 2-4), two
    attention layers 10-20 and 25-35 (kernels 11-19 and 26-30), the rest
    of the forward a kernel 40-45."""
    spans = [(WINDOW_SPAN, 1, 0, 60 * MS), ("layer.forward", 1, 0, 50 * MS),
             ("layer.forward.plan", 1, 1 * MS, 5 * MS),
             ("layer.forward.attention", 1, 10 * MS, 20 * MS),
             ("layer.forward.attention", 1, 25 * MS, 35 * MS)]
    kernels = [("k_plan", 2, 4), ("k_att", 11, 19), ("k_att", 26, 30),
               ("k_gate", 40, 45)]
    launches = {cid: (1, s * MS) for cid, (_, s, _) in enumerate(kernels)}
    device = [(name, s * MS, e * MS, cid)
              for cid, (name, s, e) in enumerate(kernels)]
    return Trace(spans, launches, device)


def record(trace=None, counters=None, images=None) -> harness.Record:
    return harness.Record(trace or traced(),
                          {"layer.build": 2} if images is None else images,
                          {"attention_bytes": 3.35e6}
                          if counters is None else counters,
                          harness.peaks())


def read(metric: str, rec):
    return harness.load_reader(metric).read(rec)


def test_span_readers():
    rec = record()
    assert read("attention_device_ms", rec) == pytest.approx((8 + 4) / 2)
    assert read("gat_plan_device_ms", rec) == pytest.approx(2 / 2)
    # 3.35 MB at 3.35 TB/s is 1 us, over 12 ms of attention
    assert read("attention_roofline", rec) == pytest.approx(
        100 * 1e-6 / 12e-3)


def test_span_readers_give_nothing_without_their_spans():
    t = traced()
    bare = Trace([s for s in t.spans if not s[0].startswith(
        "layer.forward.")], t.launches, t.device)
    for metric in NEW[:3]:
        assert read(metric, record(bare)) is None, metric
    for metric in NEW[:2]:
        assert read(metric, record(images={})) is None, metric
    assert read("attention_roofline", record(counters={})) is None


def test_fallback_reader(monkeypatch):
    stand_in = types.SimpleNamespace(counts=types.SimpleNamespace(
        plans=[{"fallback": 10}, {"fallback": 30}]))
    monkeypatch.setitem(sys.modules, SDDMM, stand_in)
    assert read("gat_fallback_edges_per_image", record()) == 20
    assert read("gat_fallback_edges_per_image", record(images={})) is None
    stand_in.counts.plans = []
    assert read("gat_fallback_edges_per_image", record()) is None
    # an older program: the module without the counter
    monkeypatch.setitem(sys.modules, SDDMM, types.SimpleNamespace())
    assert read("gat_fallback_edges_per_image", record()) is None


def test_gat_flops_by_hand():
    # 3 nodes, 4 directed edges, 2 -> 4 features, 5 edge features:
    # W_l x and W_r x 2 x 3 x 2 x 4 multiply-adds, W_e a 4 x 5 x 4, and
    # per edge and self loop (7) 3 x 4 (z's two adds, score, message).
    assert gat_flops.gatv2_flops(3, 4, 2, 4) == \
        2 * 2 * 24 + 2 * 80 + 2 * 3 * 28
    # the gate: 2 x 4 x 5 x 4 + 2 x 4 x 4 x 4 multiply-adds, the mean's
    # 4 x 4 adds and the product's 3 x 4
    assert gat_flops.gate_flops(3, 4, 4) == 160 + 128 + 16 + 12
    # 2 -> 2 features (2 heads of 1, 3 node features, 2 classes), 2
    # layers: the input projection 2 x 3 x 3 x 2, the skip 2 x 3 x 2 x 2,
    # GlobalContext 5 x 3 x 2, the head 2 x 3 x 2 x 2 + 2 x 3 x 2 x 2
    assert gat_flops.forward_flops(3, 4, 2, 2, 2, 1, in_dim=3,
                                   classes=2) == (
        36 + 24 + 30 + 24 + 24 + sum(
            gat_flops.gatv2_flops(3, 4, 2, 2) + gat_flops.gate_flops(3, 4, 2)
            for _ in range(2)))
    one = gat_flops.forward_flops(10_000, 160_000, 128, 6, 8, 16)
    assert gat_flops.forward_flops(20_000, 320_000, 128, 6, 8, 16) == 2 * one


def test_attention_bytes_by_hand():
    # xl and xr 2 x 3 x 4 bfloat16, 4 edges of 5 float32 attributes and two
    # int32 indices, the output 3 x 4 float32.
    assert attention_bytes.layer_bytes(3, 4, 4) == \
        2 * 12 * 2 + 4 * (20 + 8) + 12 * 4
    assert attention_bytes.forward_bytes(3, 4, 6, 2, 2) == \
        6 * attention_bytes.layer_bytes(3, 4, 4)
    # ~15 MB a layer at 10 000 nodes and 160 000 edges
    assert attention_bytes.layer_bytes(10_000, 160_000, 128) == 14_720_000


def test_the_cells_files_are_found_by_name():
    cell = harness.load_cell(CELL, 1, 1.0, False)
    assert cell.traffic["kind"] == "stream_gat"
    driver = harness.load_driver(cell.traffic["kind"])
    assert callable(driver.run)
    limits = harness.load_json(harness.limits_file(CELL))
    assert set(limits) == {"labels_diff", "features_err", "probs_err",
                           "trimap_diff", "cut_mask_diff", "far_trimap_diff"}
    bench = harness.load_bench()
    _, layer = harness.cell_metrics(bench, CELL)
    assert set(NEW) <= {m["name"] for m in layer}


def test_the_checkpoint_decodes_as_the_configured_gat():
    from bench_port.reference.plain.models import gat_weights
    cell = harness.load_cell(CELL, 1, 1.0, False)
    m = cell.config["model"]
    (path,) = cell.config["checkpoints"]
    model, meta = gat_weights.load(harness.ROOT / path, "cpu")
    assert meta["variant"] == m["variant"] == "gat"
    assert model.n_layers == m["n_layers"]
    assert tuple(model.p["convs.0.att"].shape) == (m["heads"], m["head_dim"])
    assert model.p["input_proj.weight"].shape[0] == m["hidden_channels"]
    assert sum(v.numel() for k, v in model.p.items() if not k.endswith(
        ("running_mean", "running_var"))) == m["params_per_member"]


def tiny_cell(seed: int) -> harness.Cell:
    cfg = harness.load_json(harness.HERE / "configs/large1536_gat.json")
    cfg.update(image_size=96, n_segments=60)
    tr = dict(harness.load_json(harness.traffic_file("stream1_gat")),
              pool=3, pool_seed=7, check_images=1, check_within=1,
              trace_seconds=1)
    return harness.Cell("tiny.gat", cfg, tr, seed, 3.0, False, 1)


@pytest.mark.parametrize("banded", [False, True], ids=["edge_list",
                                                       "banded"])
def test_tiny_run_sound_and_control(banded, monkeypatch):
    """The driver end to end on the CPU: the edge-list forward (float32,
    up to 2048 nodes) meets the reference to float32 rounding; with the
    large-path threshold lowered on both sides, the banded attention at
    its default precision meets the reference's bfloat16 rounding; the
    trimap and masks, computed from the program's posteriors on both
    sides, agree exactly; and the control's posteriors lie farther off
    than either and flip trimap pixels away from the decisions."""
    torch.set_num_threads(2)
    if banded:
        import gcn_grabcut_torch as gt
        from bench_port.reference import pipeline as ref
        monkeypatch.setattr(gt.GCNGrabCutPipeline, "LARGE_NODE_THRESHOLD",
                            16)
        monkeypatch.setattr(ref, "LARGE_NODE_THRESHOLD", 16)
    cell = tiny_cell(2**31 + 17)
    out = harness.load_driver("stream_gat").run(
        cell, lambda: None, torch.device("cpu"), control=True)
    assert out.attempted > 0 and out.failed == 0
    got, lower = out.numbers, out.control_numbers
    assert got["labels_diff"] == got["features_err"] == 0.0
    assert got["probs_err"] < (1e-3 if banded else 1e-5)
    # the stages after the forward, fed the program's posteriors
    assert got["trimap_diff"] == got["cut_mask_diff"] == 0.0
    assert lower["probs_err"] > 10 * got["probs_err"]
    # the trimap of the reference's own posteriors: no pixel away from a
    # trimap decision flips in a sound run, some do in the control's
    assert got["far_trimap_diff"] == 0.0 < lower["far_trimap_diff"]
