"""The trace reductions and the per-layer readers on synthetic records."""

import pytest

from bench_port import harness
from bench_port.trace import OUTSIDE_SPANS, WINDOW_SPAN, Trace

MS = 1_000_000   # ns


def synthetic() -> Trace:
    """A 100 ms window on thread 1: a build span 0-30 ms that launches two
    kernels, a grabcut span 40-90 ms with a mincut span inside (50-80 ms)
    that launches one kernel, and a grabcut kernel; thread 2 launches one
    kernel outside any span."""
    spans = [(WINDOW_SPAN, 1, 0, 100 * MS),
             ("layer.build", 1, 0, 30 * MS),
             ("layer.grabcut", 1, 40 * MS, 90 * MS),
             ("layer.mincut", 1, 50 * MS, 80 * MS)]
    launches = {1: (1, 1 * MS), 2: (1, 2 * MS), 3: (1, 55 * MS),
                4: (1, 45 * MS), 5: (2, 95 * MS)}
    device = [("k_build_a", 5 * MS, 15 * MS, 1),
              ("k_build_b", 15 * MS, 20 * MS, 2),
              ("k_cut", 60 * MS, 85 * MS, 3),
              ("k_gmm", 46 * MS, 50 * MS, 4),
              ("k_other", 96 * MS, 110 * MS, 5)]
    return Trace(spans, launches, device)


def test_span_device_time():
    s = synthetic().span_device_s()
    assert s["layer.build"] == pytest.approx(0.015)
    assert s["layer.mincut"] == pytest.approx(0.025)
    assert s["layer.grabcut"] == pytest.approx(0.029)   # mincut inside
    assert WINDOW_SPAN not in s


def test_busy_idle_and_breakdown():
    t = synthetic()
    assert t.window_s() == pytest.approx(0.1)
    # 5-20, 46-50, 60-85, 96-100 (clipped): 15 + 4 + 25 + 4 ms
    assert t.busy_s() == pytest.approx(0.048)
    top = t.top_device_ops()
    assert top[0] == ["k_cut", pytest.approx(0.025)]
    idle = dict(t.idle_by_host_span())
    # gaps 0-5 (build), 20-46: starts in build at 20 ms (its end is 30),
    # 50-60 (mincut), 85-96 (grabcut)
    assert idle["layer.build"] == pytest.approx(0.005 + 0.026)
    assert idle["layer.mincut"] == pytest.approx(0.010)
    assert idle["layer.grabcut"] == pytest.approx(0.011)
    assert OUTSIDE_SPANS not in idle


def test_readers():
    rec = harness.Record(synthetic(), {"layer.build": 8, "layer.grabcut": 8,
                                       "layer.cleanup": 8},
                         {"mincut_bytes": 3.35e9, "gcn_flops": 9.89e11},
                         {"hbm_bytes_per_s": 3.35e12,
                          "bf16_dense_flops_per_s": 9.89e14})
    read = {m: harness.load_reader(m).read(rec) for m in (
        "build_device_ms", "grabcut_device_ms", "cleanup_device_ms",
        "mincut_roofline", "step_mfu", "device_idle_share.batch")}
    assert read["build_device_ms"] == pytest.approx(15 / 8)
    assert read["grabcut_device_ms"] == pytest.approx(29 / 8)
    assert read["cleanup_device_ms"] is None        # no span: no reading
    assert read["mincut_roofline"] == pytest.approx(100 * 1e-3 / 0.025)
    assert read["step_mfu"] == pytest.approx(100 * 1e-3 / 0.1)
    assert read["device_idle_share.batch"] == pytest.approx(52.0)


def test_readers_return_nothing_without_data():
    empty = harness.Record(Trace([], {}, []), {}, {}, {})
    for m in ("build_device_ms", "mincut_roofline", "step_mfu",
              "device_idle_share.batch", "forward_device_ms"):
        assert harness.load_reader(m).read(empty) is None


def test_cut_mask_diff_is_the_larger_of_cut_and_mask():
    import numpy as np
    from bench_port.reference import compare
    ref = {"node_mask": np.ones(2, bool), "grabcut": np.zeros((4, 4)),
           "mask": np.zeros((4, 4))}
    cut = np.zeros((4, 4))
    cut[0, :2] = 1
    n = compare.image_numbers({"grabcut": cut, "mask": ref["mask"]}, ref)
    assert n["grabcut_diff"] == 2 / 16 and n["mask_diff"] == 0
    assert n["cut_mask_diff"] == 2 / 16
    assert "cut_mask_diff" not in compare.image_numbers({"mask": cut}, ref)
