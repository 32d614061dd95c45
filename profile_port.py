#!/usr/bin/env python3
"""Where the port's main path spends the card's time.

    python3 profile_port.py

Runs chip_smoke.py's main-path configuration on one GPU (a 1536x1536
synthetic image, 10 000 SLIC segments, the seeded ResGCNNet at D=128,
n_layers=6, B=1): a warm run and a timed run of segment_batch, then the
same call, and its GrabCut stage alone, under torch.profiler recording
device activity only.  For each it prints the unprofiled wall time, the
device's busy time (the union of its activity intervals) and busy share,
the number of device activities, and the heaviest kernels.  Profiling
slows the host, not the kernels, so busy time is set against the
unprofiled wall time.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time

import torch


def device_profile(fn) -> tuple[float, int, list]:
    """(busy seconds, activity count, [(name, ms, count)] heaviest five)
    of the device work fn() queues."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    per_name: dict = {}
    for s, e, name in spans:         # microseconds
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = per_name.get(name, (0.0, 0))
        per_name[name] = (t + e - s, n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:5]
    return busy / 1e6, len(spans), [(k, t / 1e3, n) for k, (t, n) in top]


def report(label: str, wall: float, fn) -> None:
    busy, count, top = device_profile(fn)
    if not count:
        print(f"{label}: device busy time not measured (the profiler "
              "recorded no device activity)", flush=True)
        return
    print(f"{label}: wall {wall:.3f} s, device busy {busy:.3f} s (busy "
          f"share {busy / wall:.3f}), {count} device activities", flush=True)
    for name, ms, n in top:
        print(f"    {ms:9.1f} ms  x{n:<7d} {name[:110]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", flush=True)
        sys.exit(1)
    import chip_smoke as cs
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.grabcut import grabcut_batch_device

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__}, {cs.gpu_line()}", flush=True)
    cfg = gt.SuperpixelGraphConfig(n_segments=cs.N_SEGMENTS)
    model = gt.ResGCNNet(
        hidden_channels=cs.HIDDEN, n_layers=cs.N_LAYERS,
        generator=torch.Generator().manual_seed(cs.MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = cs.make_image(cs.IMAGE_HW)

    pipe.segment_batch([img])                                  # warm
    t = time.perf_counter()
    res = pipe.segment_batch([img], sync_timing=True)[0]
    wall = time.perf_counter() - t
    print("stages: " + " ".join(f"{k}={v:.3f}s"
                                for k, v in res.timing.items()), flush=True)
    report("segment_batch", wall, lambda: pipe.segment_batch([img]))

    rgbs = torch.as_tensor(img[None], device=pipe.device).float()
    trimaps = torch.as_tensor(res.trimap[None], device=pipe.device)
    torch.cuda.synchronize()
    t = time.perf_counter()
    grabcut_batch_device(rgbs, trimaps, pipe.gc_config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    report("grabcut stage", wall,
           lambda: grabcut_batch_device(rgbs, trimaps, pipe.gc_config))


if __name__ == "__main__":
    main()
