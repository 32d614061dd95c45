#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (gcn_grabcut_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. versions and the card's name and power limit;
  2. build every CUDA kernel in gcn_grabcut_torch/csrc/ (one nvcc per
     source, all in parallel);
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, with its time, the plain version's time, a one-call
     PyTorch yardstick and the bound the card's peak rates allow;
  4. the main path: GCNGrabCutPipeline.segment_batch on a 1536x1536
     synthetic image with 10 000 SLIC segments and a seeded ResGCNNet at
     D=128, n_layers=6 -- a warm run, then a timed run with the kernel
     launch counts set to 0 just before and read just after; the card's
     forward is then held against the plain forward on the CPU.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.  Needs CUDA; imports nothing of
JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): HBM3 bytes/s, bf16 tensor-core and
# fp32 (non-tensor) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

IMAGE_HW = 1536
N_SEGMENTS = 10_000
HIDDEN, N_LAYERS = 128, 6
# Random weights from this seed give a trimap with all four labels and
# ~95% probable pixels on make_image(1536), so GrabCut has real work
# (seed 0 labels every pixel foreground-side).
MODEL_SEED = 4
SPMM_TOL = 1e-4        # kernel vs plain: same products, fp32 sums reordered
FORWARD_TOL = 2e-2     # card (bf16 kernel) vs CPU plain forward, logits


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn() after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_image(hw: int, seed: int = 0) -> np.ndarray:
    """Blocky noise with a brighter disc (tools/bench_large.py's recipe)."""
    r = np.random.RandomState(seed)
    img = np.kron(r.rand(hw // 8, hw // 8, 3), np.ones((8, 8, 1)))
    yy, xx = np.mgrid[0:hw, 0:hw]
    cy, cx = hw // 2, int(hw * 0.47)
    blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < (hw // 4) ** 2
    img[blob] = img[blob] * 0.25 + r.rand(3) * 0.75
    return (img * 255).astype(np.uint8)


def slic_like_edges(side: int, n_nonlocal: int, seed: int):
    """Directed edges of a side x side 4-connected grid in scan order plus
    random non-local pairs, both directions: the structure SLIC labels
    give the large path."""
    r = np.random.RandomState(seed)
    idx = np.arange(side * side).reshape(side, side)
    pairs = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
             np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)]
    n = side * side
    nl = np.stack([np.repeat(np.arange(n), n_nonlocal),
                   r.randint(0, n, n * n_nonlocal)], 1)
    pairs.append(nl[nl[:, 0] != nl[:, 1]])
    p = np.concatenate(pairs)
    return np.concatenate([p[:, 0], p[:, 1]]), np.concatenate([p[:, 1],
                                                               p[:, 0]])


def check_banded_spmm(dev) -> dict:
    """K1 against its plain version at the main path's shapes, bf16 (the
    path's dtype) and fp32.  Returns the bf16 record for the JSON line."""
    from gcn_grabcut_torch.models.large import build_gcn_plans_device
    from gcn_grabcut_torch.ops.spmm import (banded_spmm_cuda,
                                            banded_spmm_plain)
    side = int(round(N_SEGMENTS ** 0.5))
    n = side * side
    src, dst = slic_like_edges(side, 4, seed=0)
    src = torch.as_tensor(src, device=dev)
    dst = torch.as_tensor(dst, device=dev)
    mask = torch.ones(src.shape, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x32 = torch.randn((n, HIDDEN), generator=gen, device=dev)
    record = None
    for dtype in (torch.bfloat16, torch.float32):
        plan, _ = build_gcn_plans_device(src, dst, mask, n, dtype=dtype)
        band = plan.band
        K, n_pad, R = band.shape
        x = x32.to(dtype).contiguous()
        out = banded_spmm_cuda(x, band)
        torch.cuda.synchronize()
        ref = banded_spmm_plain(x, band)
        err = float((out - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        ok = err <= SPMM_TOL * scale
        ms = time_ms(lambda: banded_spmm_cuda(x, band))
        plain_ms = time_ms(lambda: banded_spmm_plain(x, band))

        # Yardstick only: one torch.bmm of the band as (nb, R, K*R)
        # against the overlapping (nb, K*R, D) slabs of the padded x.
        nb, off0 = n_pad // R, K // 2
        band_b = band.reshape(K, nb, R, R).permute(1, 2, 0, 3).reshape(
            nb, R, K * R).contiguous()
        xpad = torch.nn.functional.pad(
            x, (0, 0, off0 * R, (K - 1 - off0) * R + n_pad - n))
        slabs = xpad.as_strided((nb, K * R, HIDDEN), (R * HIDDEN, HIDDEN, 1))
        lib_err = float((torch.bmm(band_b, slabs).float().reshape(
            n_pad, HIDDEN) - ref).abs().max())
        library_ms = time_ms(lambda: torch.bmm(band_b, slabs))

        elt = band.element_size()
        n_bytes = band.numel() * elt + n * HIDDEN * elt + n_pad * HIDDEN * 4
        n_ops = 2 * n_pad * K * R * HIDDEN
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
        rec = {"name": "banded_spmm", "route": "cuda",
               "source": "gcn_grabcut_torch/csrc/banded_spmm.cu",
               "replaces": "gcn_grabcut_tpu/ops/spmm.py:236",
               "launches": 0, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "library_ms": library_ms}
        print(f"K1 banded_spmm {str(dtype)[6:]} n_pad={n_pad} R={R} K={K} "
              f"D={HIDDEN}: max_abs_err={err:.3e} (tol {SPMM_TOL * scale:.1e})"
              f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bmm yardstick "
              f"{library_ms:.4f} ms (err {lib_err:.2e}), bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP)", flush=True)
        if not ok:
            fail(f"banded_spmm {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            record = rec
    return record


def run_main_path(dev, record: dict) -> None:
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.graph_build import num_nodes_for
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    k = num_nodes_for(IMAGE_HW, IMAGE_HW, cfg)
    if k <= gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD:
        fail(f"K={k} does not take the large-graph path")
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = make_image(IMAGE_HW)

    t = time.perf_counter()
    pipe.segment_batch([img])
    print(f"main path warm run: {time.perf_counter() - t:.3f} s", flush=True)

    banded_spmm.kernel_launches = 0
    t = time.perf_counter()
    res = pipe.segment_batch([img], sync_timing=True)[0]
    wall = time.perf_counter() - t
    launches = banded_spmm.kernel_launches
    record["launches"] = launches
    stages = " ".join(f"{s}={v:.3f}s" for s, v in res.timing.items())
    fg = float(res.binary_mask.mean())
    tri = np.bincount(res.trimap.ravel(), minlength=4) / res.trimap.size
    print(f"main path timed run (B=1, {IMAGE_HW}^2, K={k}, ResGCNNet "
          f"D={HIDDEN} n={N_LAYERS}): {wall:.3f} s; {stages}; "
          f"banded_spmm launches={launches}; trimap BG/FG/PR_BG/PR_FG="
          f"{'/'.join(f'{v:.3f}' for v in tri)}; FG fraction={fg:.4f}",
          flush=True)
    if launches != N_LAYERS + 1:
        fail(f"banded_spmm launched {launches} times, expected "
             f"{N_LAYERS + 1} per forward")
    if res.probs.shape != (k, 3) or not np.isfinite(res.probs).all():
        fail("posteriors are not finite (K, 3)")
    if not 0.0 < fg < 1.0:
        fail(f"degenerate mask (FG fraction {fg})")

    # The card's forward (bf16 kernel) against the plain forward on the
    # CPU, same graph and weights.
    rgbs = torch.as_tensor(img[None], device=dev).float()
    out = gt.build_graph_batch_arrays(rgbs, cfg, device=dev)
    g = gt.make_graph_batch(
        x=out["x"], edge_src=out["edge_src"], edge_dst=out["edge_dst"],
        edge_attr=out["edge_attr"], node_mask=out["node_mask"],
        edge_mask=out["edge_mask"], node_area=out["node_area"])
    logits = apply_large(pipe.model, g).float().cpu()
    g_cpu = gt.make_graph_batch(
        **{f: getattr(g, f).cpu() for f in ("x", "edge_src", "edge_dst",
                                            "edge_attr", "node_mask",
                                            "edge_mask", "node_area")},
        device="cpu")
    ref = apply_large(pipe.model.to("cpu"), g_cpu, device="cpu")
    valid = g_cpu.node_mask[0] > 0
    err = float((logits[0][valid] - ref[0][valid]).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"forward card vs CPU plain: max |dlogits|={err:.3e} "
          f"(tol {FORWARD_TOL * scale:.1e})", flush=True)
    if err > FORWARD_TOL * scale:
        fail("the card's forward disagrees with the plain CPU forward")


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    import gcn_grabcut_torch  # noqa: F401  (fails outside the checkout)
    from gcn_grabcut_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{card}", flush=True)

    t = time.perf_counter()
    libs = kernels.build()
    print(f"kernel build: {time.perf_counter() - t:.2f} s "
          f"({', '.join(sorted(libs))})", flush=True)

    record = check_banded_spmm(dev)
    run_main_path(dev, record)

    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
