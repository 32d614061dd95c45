"""A run driven end to end on the CPU at a tiny size (the look for a card
skipped): sound, it comes out correct; with the timed path broken
underneath, it does not.  The faults an inference cell can have: an
answer altered where it is produced, and half of a batch left out (its
images given the other half's answers)."""

import time

import pytest
import torch

from bench_port import harness


def tiny_cell() -> harness.Cell:
    cfg = harness.load_json(harness.HERE / "configs/dense512_ens3.json")
    cfg.update(image_size=96, n_segments=40)
    tr = dict(kind="stream", pool=4, pool_seed=7, batch_size=2,
              ms_scales=[1.0, 0.5], max_images=400, check_images=4,
              check_within=6, trace_seconds=1)
    return harness.Cell("tiny.stream", cfg, tr, 5, 4.0, False, 1)


def execute(cell: harness.Cell) -> dict:
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_port_run", harness.HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    names = ("labels_diff", "features_err", "probs_err", "trimap_diff",
             "grabcut_diff", "mask_diff")
    limits = {n: 0.0 for n in names}
    if "probs_err" in limits:
        limits["probs_err"] = 1e-5     # batched against alone, float32
    return run.execute(cell, torch.device("cpu"), "cpu", 1,
                       time.perf_counter(), limits)


def altered(fn):
    """grabcut_batch_device whose first image's mask has a block flipped."""
    def grabcut(rgbs, trimaps, *a, **k):
        masks = fn(rgbs, trimaps, *a, **k).clone()
        masks[0, 8:40, 8:40] = 1 - masks[0, 8:40, 8:40]
        return masks
    return grabcut


def half_left_out(fn):
    """grabcut_batch_device that solves the first half of the batch and
    hands the second half the first half's masks."""
    def grabcut(rgbs, trimaps, *a, **k):
        half = max(1, rgbs.shape[0] // 2)
        masks = fn(rgbs[:half], trimaps[:half], *a, **k)
        reps = -(-rgbs.shape[0] // half)
        return masks.repeat(reps, 1, 1)[:rgbs.shape[0]]
    return grabcut


def test_sound_run_is_correct():
    res = execute(tiny_cell())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_broken_path_is_not_correct(fault, monkeypatch):
    from gcn_grabcut_torch import pipeline
    monkeypatch.setattr(pipeline, "grabcut_batch_device",
                        fault(pipeline.grabcut_batch_device))
    res = execute(tiny_cell())
    assert not res["correct"], res["checks"]
