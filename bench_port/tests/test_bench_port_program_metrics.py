"""The readers of the program's own spans and counters, on hand-built
records and a stand-in for ``ops.maxflow.counts``; and on the CPU, a batch
run under the hooks' spans inside a profiler window: the program's spans
of the hooks' names cover every operator the hooks' spans cover."""

import types

import numpy as np
import pytest

from bench_port import counters, harness
from bench_port.trace import WINDOW_SPAN, Trace

MS = 1_000_000   # ns


def traced() -> Trace:
    """A 100 ms window on thread 1: upload 0-4 ms (a copy 1-3 ms), the
    projection 10-12 and trimap 13-20 (kernels 10-11 and 14-16), a GrabCut
    span 21-60 with a k-means span 22-25 (kernel 22-24), a GMM span 30-39
    (kernel 31-39) and a min-cut span 40-55 (kernel 41-51), then the
    finalize span 61-100 with its pull 62-70 (a copy 62-64) and compose
    75-95."""
    spans = [(WINDOW_SPAN, 1, 0, 100 * MS),
             ("layer.upload", 1, 0, 4 * MS),
             ("layer.project", 1, 10 * MS, 12 * MS),
             ("layer.trimap", 1, 13 * MS, 20 * MS),
             ("layer.grabcut", 1, 21 * MS, 60 * MS),
             ("layer.grabcut.kmeans", 1, 22 * MS, 25 * MS),
             ("layer.grabcut.gmm", 1, 30 * MS, 39 * MS),
             ("layer.mincut", 1, 40 * MS, 55 * MS),
             ("layer.finalize", 1, 61 * MS, 100 * MS),
             ("layer.finalize.pull", 1, 62 * MS, 70 * MS),
             ("layer.finalize.compose", 1, 75 * MS, 95 * MS)]
    kernels = [("copy_h2d", 1, 3), ("k_proj", 10, 11), ("k_tri", 14, 16),
               ("k_kmeans", 22, 24), ("k_gmm", 31, 39), ("k_cut", 41, 51),
               ("copy_d2h", 62, 64)]
    launches = {cid: (1, s * MS) for cid, (_, s, _) in enumerate(kernels)}
    device = [(name, s * MS, e * MS, cid)
              for cid, (name, s, e) in enumerate(kernels)]
    return Trace(spans, launches, device)


def record(trace: Trace, images=None) -> harness.Record:
    images = {"layer.build": 4, "layer.grabcut": 4} if images is None \
        else images
    return harness.Record(trace, images, {}, {})


def read(metric: str, rec):
    return harness.load_reader(metric).read(rec)


def test_span_readers():
    rec = record(traced())
    assert read("gmm_device_ms", rec) == pytest.approx((2 + 8) / 4)
    assert read("trimap_device_ms", rec) == pytest.approx((1 + 2) / 4)
    assert read("upload_device_ms", rec) == pytest.approx(2 / 4)
    # one gap, 64-100 ms, labelled by its start: the pull
    assert read("finalize_idle_ms", rec) == pytest.approx(36 / 4)


def test_span_readers_give_nothing_without_their_spans():
    t = traced()
    bare = Trace([s for s in t.spans if s[0] in (WINDOW_SPAN,
                                                 "layer.grabcut",
                                                 "layer.mincut",
                                                 "layer.trimap")],
                 t.launches, t.device)
    for metric in ("gmm_device_ms", "trimap_device_ms", "upload_device_ms",
                   "finalize_idle_ms"):
        assert read(metric, record(bare)) is None, metric
        assert read(metric, record(t, images={})) is None, metric
        assert read(metric, harness.Record(Trace([], {}, []), {}, {},
                                           {})) is None


def test_counter_readers(monkeypatch):
    from gcn_grabcut_torch.ops import maxflow
    stand_in = types.SimpleNamespace(kernel_tallies=[
        dict(barriers=1023, swept_tiles=20_000),
        dict(barriers=201, swept_tiles=3_000)])
    monkeypatch.setattr(maxflow, "counts", stand_in)
    rec = record(Trace([], {}, []), {"layer.grabcut": 2})
    assert read("mincut_barriers_per_image", rec) == pytest.approx(612.0)
    assert read("mincut_swept_tiles_per_image", rec) == \
        pytest.approx(11_500.0)
    assert read("mincut_barriers_per_image", record(
        Trace([], {}, []), {})) is None
    stand_in.kernel_tallies = []
    assert read("mincut_barriers_per_image", rec) is None
    monkeypatch.delitem(__import__("sys").modules, counters.MAXFLOW)
    assert counters.mincut_tallies() == []


SHARED = ("layer.build", "layer.forward", "layer.grabcut", "layer.mincut",
          "layer.cleanup")


def test_program_spans_cover_the_hooks_spans():
    """For each name both the hooks and the program open, every operator
    inside a hook's span lies inside the program's span of that name
    within it, so the device time per name reads the same launches."""
    import torch

    import gcn_grabcut_torch as gt
    from bench_port.hooks import Hooks
    from bench_port.trace import Window

    torch.manual_seed(0)
    pipe = gt.GCNGrabCutPipeline(
        gt.ResGCNNet(hidden_channels=8, n_layers=2),
        gt.SuperpixelGraphConfig(n_segments=30, bg_connectivity=True),
        device="cpu")
    r = np.random.RandomState(0)
    images = [r.randint(30, 220, (48, 48, 3)).astype(np.uint8)
              for _ in range(2)]
    hooks = Hooks(pipe, 48, spans=True)
    with hooks.installed(), Window(True) as window:
        hooks.counting = True
        pipe.segment_batch(images, ms_scales=(1.0, 0.75))
        hooks.counting = False
    events = list(window._prof.profiler.kineto_results.events())
    ops = [(e.start_thread_id(), e.start_ns(),
            e.start_ns() + e.duration_ns()) for e in events
           if e.name().startswith("aten::")]
    for name in SHARED:
        spans = [(e.start_thread_id(), e.start_ns(),
                  e.start_ns() + e.duration_ns()) for e in events
                 if e.name() == name]

        def inside(a, b):
            return a[0] == b[0] and b[1] <= a[1] and a[2] <= b[2]

        outer = [s for s in spans
                 if not any(o != s and inside(s, o) for o in spans)]
        assert outer and 2 * len(outer) == len(spans), name
        for hook in outer:
            own = [s for s in spans if s != hook and inside(s, hook)]
            assert len(own) == 1, name
            within = [op for op in ops if inside(op, hook)]
            assert within, name
            assert all(inside(op, own[0]) for op in within), name
    assert window.trace.span_device_s() == {}      # no card: no activity
