"""The port's own tracing on the CPU: the spans `segment_batch` opens under
a torch profiler (every name of `utils`' span table, each inside its
parent), nothing of record_function without one, the min-cut solves
`ops.maxflow.counts` records while a profiler runs, the tallies file
`profile_trace` writes, and the stage clock behind `timing`.  48 px
images, so each batch takes about a second.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gcn_grabcut_torch as gt
from gcn_grabcut_torch import pipeline as tpipe
from gcn_grabcut_torch import utils
from gcn_grabcut_torch.ops import maxflow as tmf
from test_torch_cuda import mincut_case

torch.set_num_threads(1)

HW, N_SEGMENTS = 48, 30

#: The span table of utils' docstring: name -> parent (None at the top).
SPANS = {
    "layer.upload": None, "layer.build": None,
    "layer.build.slic": "layer.build",
    "layer.build.connectivity": "layer.build",
    "layer.build.regions": "layer.build", "layer.build.edges": "layer.build",
    "layer.build.prior": "layer.build", "layer.forward": None,
    "layer.project": None, "layer.trimap": None, "layer.grabcut": None,
    "layer.grabcut.kmeans": "layer.grabcut",
    "layer.grabcut.caps": "layer.grabcut",
    "layer.grabcut.gmm": "layer.grabcut", "layer.mincut": "layer.grabcut",
    "layer.cleanup": None, "layer.finalize": None,
    "layer.finalize.pull": "layer.finalize",
    "layer.finalize.unpack": "layer.finalize",
    "layer.finalize.compose": "layer.finalize",
}


def batch() -> list:
    out = []
    for seed in range(2):
        r = np.random.RandomState(seed)
        img = r.randint(40, 90, (HW, HW, 3))
        yy, xx = np.mgrid[0:HW, 0:HW]
        img[(yy - 24) ** 2 + (xx - 20 - 4 * seed) ** 2 < 150] += 120
        out.append(img.astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    return gt.GCNGrabCutPipeline(
        gt.ResGCNNet(hidden_channels=8, n_layers=2),
        gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS, bg_connectivity=True),
        device="cpu")


def spans_of(prof) -> list:
    """(name, thread, start, end) of every layer span the profiler saw."""
    return [(e.name(), e.start_thread_id(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("layer.")]


@pytest.mark.parametrize("ms_scales", [None, (1.0, 0.75)],
                         ids=["one_scale", "two_scales"])
def test_segment_batch_opens_every_span_inside_its_parent(pipe, ms_scales):
    images = batch()
    plain = pipe.segment_batch(images, ms_scales=ms_scales)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pipe.segment_batch(images, ms_scales=ms_scales)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a.binary_mask, b.binary_mask)
    spans = spans_of(prof)
    assert {name for name, *_ in spans} == set(SPANS)
    n = {name: sum(s[0] == name for s in spans) for name in SPANS}
    scales = len(ms_scales or (1.0,))
    assert n["layer.build"] == n["layer.forward"] == scales
    assert n["layer.build.connectivity"] == scales
    # a projection per scale, and at two scales the resize and the mean
    assert n["layer.project"] == (1 if scales == 1 else 2 * scales)
    # GrabCut's 5 iterations: a min-cut and a GMM step each, and the fit
    assert n["layer.mincut"] == 5 and n["layer.grabcut.gmm"] == 6
    for name, tid, start, end in spans:
        parent = SPANS[name]
        if parent is not None:
            assert any(p == parent and t == tid and s <= start and end <= e
                       for p, t, s, e in spans), (name, parent)
    # Spans under one parent do not overlap, nor the projection and trimap.
    for parent in set(SPANS.values()):
        kids = sorted((s, e, name) for name, _, s, e in spans
                      if SPANS[name] == parent
                      or (parent is None and name in ("layer.project",
                                                      "layer.trimap")))
        for (_, end, a), (start, _, b) in zip(kids, kids[1:]):
            assert end <= start, (a, b)


def test_no_span_enters_record_function_without_a_profiler(pipe,
                                                           monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(utils, "record_function", refuse)
    assert not utils.tracing()
    assert utils.trace_span("layer.build") is utils.trace_span("x")
    res = pipe.segment_batch(batch(), ms_scales=(1.0, 0.75))
    assert len(res) == 2


def test_plain_solves_are_recorded_under_a_profiler_only(monkeypatch):
    fresh = tmf.SolverCounts()
    monkeypatch.setattr(tmf, "counts", fresh)
    ex, r_fwd, r_bwd, conn, kw = mincut_case("lock-step")
    for _ in range(3):
        tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    assert not fresh.recording and fresh._calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
        tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    assert not fresh.recording
    assert [r.tolist() for r in fresh.rounds] == [[0, 4, 9]] * 2
    totals = fresh.totals()
    assert totals["solves"] == 2 and totals["rounds"] == 26
    assert totals["relabel_steps"] == 2 * 484
    assert totals["barriers"] == totals["swept_tiles"] == 0


def test_kernel_solves_copy_tallies_under_a_profiler(monkeypatch):
    """A kernel solve (mocked as in test_torch_mincut_kernel) takes one
    pinned copy and one event while a profiler records, with no reset()."""
    fresh = tmf.SolverCounts()
    monkeypatch.setattr(tmf, "counts", fresh)
    pinned, events = [], []
    real_empty = torch.empty

    class Passed:
        def record(self, stream):
            events.append(self)

        def query(self):
            return True

        def synchronize(self):
            pass

    def empty(*args, pin_memory=False, **kwargs):
        if pin_memory:
            pinned.append(args)
        return real_empty(*args, **kwargs)

    def launch(e, rf, rb, *args):
        ctrl = torch.zeros(tmf.CTRL_HEAD + 2 * e.shape[0], dtype=torch.int32)
        ctrl[1], ctrl[4] = 7, 11          # barriers, tiles swept
        return (torch.zeros(e.shape, dtype=torch.bool, device=e.device),
                ctrl, dict(blocks=1))

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "Event", Passed)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(tmf, "grid_mincut_cuda", launch)
    ex, r_fwd, r_bwd, conn, kw = mincut_case("lock-step")
    meta = (ex.to("meta"), tuple(r.to("meta") for r in r_fwd),
            tuple(r.to("meta") for r in r_bwd))
    tmf.grid_mincut_batch(*meta, conn, **kw)
    assert pinned == [] and events == []
    with profile(activities=[ProfilerActivity.CPU]):
        tmf.grid_mincut_batch(*meta, conn, **kw)
    assert len(pinned) == 1 and len(events) == 1
    assert [t["barriers"] for t in fresh.kernel_tallies] == [7]
    assert fresh.totals()["swept_tiles"] == 11


def test_profile_trace_writes_the_mincut_tallies(tmp_path, monkeypatch):
    fresh = tmf.SolverCounts()
    monkeypatch.setattr(tmf, "counts", fresh)
    ex, r_fwd, r_bwd, conn, kw = mincut_case("conn8")
    tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    fresh.syncs = 99                      # cleared on entry
    with utils.profile_trace(tmp_path):
        tmf.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    trace = list(tmp_path.glob("*.pt.trace.json"))
    tallies = list(tmp_path.glob("*.mincut.json"))
    assert len(trace) == len(tallies) == 1
    assert tallies[0].name.split(".")[0] == trace[0].name.split(".")[0]
    got = json.loads(tallies[0].read_text())
    assert got == dict(solves=1, rounds=4, relabel_steps=70, barriers=0,
                       swept_tiles=0, relax_tiles=0, syncs=40)


def test_stage_clock_reads_cuda_events_without_a_sync(monkeypatch):
    """On the card a batch's stage times are the device timeline between
    events recorded at the boundaries, read with no synchronize."""
    recorded = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None

        def record(self, stream):
            assert stream == "stream"
            self.at = 10.0 * len(recorded)       # ms on the device clock
            recorded.append(self)

        def elapsed_time(self, other):
            return other.at - self.at

    def refuse(*a, **k):
        raise AssertionError("a host sync")

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    clock = tpipe._StageClock(torch.device("cuda", 0))
    for name in ("graph_build", "gcn_inference", "grabcut"):
        clock.mark(name)
    assert len(recorded) == 4
    assert clock.seconds() == {"graph_build": 0.01, "gcn_inference": 0.01,
                               "grabcut": 0.01}


def test_segment_batch_timing_on_the_host_clock(pipe):
    res = pipe.segment_batch(batch())
    assert list(res[0].timing) == ["graph_build", "gcn_inference", "grabcut",
                                   "postprocess"]
    assert all(v > 0 for v in res[0].timing.values())
    assert res[0].timing == res[1].timing
