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
     K1 at the banded SpMM's shapes, also timed with the L2 flushed before
     every call, with the share of its bound it reaches; K2 and K3 (the
     one-shot direct-write all-gather and direct-read reduce-scatter) at
     the sharded path's shapes (n = 4 ranks of one (rows/4, 128) block)
     and at n = 2 and 8 over the same rows, in float32 and bfloat16, each
     one's allocations held to its outputs, then >= 100 calls for each n
     with fresh seeded data and seeded timing skew between ranks, every
     output exact;
  4. the main path: GCNGrabCutPipeline.segment_batch on a 1536x1536
     synthetic image with 10 000 SLIC segments and a seeded ResGCNNet at
     D=128, n_layers=6 -- a warm run, then a timed run with the kernel
     launch counts set to 0 just before and read just after; the card's
     forward is then held against the plain forward on the CPU;
  5. the graph-sharded path on the same graph and model: the forward
     through mesh_aggregators over 4 ranks with the ring halo (K2) and the
     gradient of sum(logits * c) for every parameter (K3), after a warm
     call, with the counts set to 0 just before and read just after; held
     against apply_large(precision="highest") and the backward with the
     plain halo;
  6. the dense path, the configuration the repo recommends: the 3-member
     bgc ensemble read from examples/ensemble_r5/ by the port's own
     checkpoint reader, GCNGrabCutPipeline.segment_batch at 512x512 with
     500 superpixels (K = 484), the geodesic prior, θ 0.65, guided-filter
     radius 4 and ms_scales (1.0, 0.75), on 8 make_image(512) images --
     warm runs, a timed B=1 run of each image with stage times, a timed
     B=8 run (images/s) and a B=8 run with stage times, with the K1
     count set to 0 just before and read just after (it must stay 0); the card's ensemble posteriors held against
     the CPU's on the same graphs, and the outputs against the JAX
     package's (tests/data/torch_dense_jax_ref.npz): SLIC agreement,
     posteriors where the labels agree, mask IoU;
  7. the staged paths at the same configuration, on make_image(512) seeds
     1 and 3 with seeded pixel noise: segment(edge_aware=False), segment(refine_iters=2),
     segment() with the native C++ min-cut (built here with g++),
     segment_bbox, and the GrabCut class from a box then refine(2) in HSV
     and Lab, each held against the JAX package's outputs
     (tests/data/torch_staged_jax_ref.npz) by mask IoU, segment_bbox's
     trimap exactly; the native solver's time beside the device solver's
     on the same trimap; segment_stream over four images in chunks of
     three against segment_batch on the same chunks, beside two
     segment_batch runs against each other; predict_probs on the main
     path's 1536x1536 graph (7 K1 launches) against segment_batch's
     posteriors; K1 launched 0 times on the 512 px items.  Before them,
     keep-largest's fixed-order sums (20 repeats on one 512x512 mask, bit
     for bit), and a flat-colour image through the dense path on the card
     and on the CPU (the std-Lab feature's cancellation, reported).
Phase 1 also reports whether cv2, PIL and networkx import (information
only).  Kernel times are device times: the launches run back to back
behind a device sleep, so the host's launch cost is not counted.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}.  Needs CUDA; imports nothing of
JAX.
"""

from __future__ import annotations

import importlib
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
L2_FLUSH_BYTES = 64 << 20   # written between calls for a cold-L2 time
FORWARD_TOL = 2e-2     # card (bf16 kernel) vs CPU plain forward, logits
RING_SIZES = (2, 4, 8)
PATH_RANKS = 4
STRESS_CALLS = 100
STRESS_MAX_DELAY_NS = 20_000
# K3's yardstick sums over ranks in another order: fp32 within 1e-5 of the
# sum's scale, bf16 within 2 ulp at that scale.
YARDSTICK_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# Sharded forward vs apply_large(precision="highest"): the same fp32 sums,
# reordered, and edge weights rounded differently.
SHARDED_FWD_TOL = 1e-3
# Sharded backward, ring halo vs plain halo: index_add_ atomics reorder sums.
SHARDED_GRAD_TOL = 1e-4

# The dense path: the configuration the repo recommends
# (examples/ensemble_r5/README.md), on DENSE_IMAGES make_image(DENSE_HW)
# images; tests/data/torch_dense_jax_ref.npz holds the JAX package's
# outputs on them (tests/make_torch_dense_jax_ref.py).
DENSE_CHECKPOINTS = tuple(f"examples/ensemble_r5/bgc_s4{i}.msgpack"
                          for i in (2, 3, 4))
DENSE_HW, DENSE_IMAGES, DENSE_SEGMENTS = 512, 8, 500
DENSE_SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4,
                      ms_scales=(1.0, 0.75))
DENSE_REF = "tests/data/torch_dense_jax_ref.npz"
DENSE_CPU_TOL = 1e-4   # card vs CPU ensemble posteriors: fp32, no TF32
# Card vs JAX posteriors where SLIC agrees fully.  The std-Lab features of
# near-uniform regions come from E[x^2] - E[x]^2 in fp32, which cancels,
# and the card sums them in another order: 1.5e-3 measured on the CPU.
DENSE_JAX_TOL = 1e-2
DENSE_MIN_IOU = 0.99   # mean mask IoU against JAX (k-means seeds differ)

# The staged paths, at the dense path's configuration (ms_scales aside:
# the staged branch ignores it) on staged_image(seed) for these seeds;
# tests/data/torch_staged_jax_ref.npz holds the JAX package's outputs
# (tests/make_torch_staged_jax_ref.py).
STAGED_SEEDS = (1, 3)
# make_image's 8x8 blocks are flat: a GMM component holding a few dozen
# pixels of one block has a covariance E[xx^T] - mm^T that is float32
# noise, and a box-initialised GrabCut in HSV then parts between the two
# packages (seed 3: mask IoU 0.958 on the CPU).  Seeded pixel noise of
# this amplitude keeps every component well-conditioned.
STAGED_NOISE = 12
STAGED_SETTINGS = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4)
STAGED_BBOX = (96, 112, 288, 288)      # (x, y, w, h) around the disc
STAGED_REFINE = 2
STAGED_COLOUR_SPACES = ("hsv", "lab")
STAGED_REF = "tests/data/torch_staged_jax_ref.npz"
STREAM_SEEDS, STREAM_BATCH = (1, 3, 4, 6), 3
# predict_probs(RegionGraph) vs segment_batch's posteriors on the main
# path's image: two builds of one graph, whose float sums the card may
# order differently.
PREDICT_TOL = 1e-3
KEEP_LARGEST_REPEATS = 20


def optional_packages() -> str:
    """Which optional packages import here, with their versions."""
    parts = []
    for name in ("cv2", "PIL", "networkx"):
        try:
            mod = importlib.import_module(name)
        except Exception as e:   # ImportError, or a broken native library
            parts.append(f"{name} no ({type(e).__name__}: {e})")
        else:
            parts.append(f"{name} {getattr(mod, '__version__', '?')}")
    return "optional packages: " + ", ".join(parts)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Device milliseconds per fn() call: `reps` calls run back to back
    between two CUDA events, queued behind a device sleep long enough for
    the host to queue them all, so the host's launch cost is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    slept.record()
    torch.cuda._sleep(300_000_000)       # ~0.15 s at the H100's clocks
    start.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    end.record()
    end.synchronize()
    if host_ms > slept.elapsed_time(start):
        print(f"  (timing: queueing {reps} calls took {host_ms:.1f} ms, "
              f"longer than the sleep; the time includes host gaps)",
              flush=True)
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int = 30) -> float:
    """Device milliseconds per fn() call with a cold L2: each call follows a
    write of L2_FLUSH_BYTES, whose own time, measured alone, is
    subtracted."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    both = time_ms(lambda: (scratch.zero_(), fn()), reps)
    return both - time_ms(scratch.zero_, reps)


def make_image(hw: int, seed: int = 0) -> np.ndarray:
    """Blocky noise with a brighter disc (tools/bench_large.py's recipe)."""
    r = np.random.RandomState(seed)
    img = np.kron(r.rand(hw // 8, hw // 8, 3), np.ones((8, 8, 1)))
    yy, xx = np.mgrid[0:hw, 0:hw]
    cy, cx = hw // 2, int(hw * 0.47)
    blob = ((yy - cy) ** 2 + (xx - cx) ** 2) < (hw // 4) ** 2
    img[blob] = img[blob] * 0.25 + r.rand(3) * 0.75
    return (img * 255).astype(np.uint8)


def staged_image(seed: int) -> np.ndarray:
    """make_image(DENSE_HW, seed) with seeded uniform noise of
    +-STAGED_NOISE on every channel."""
    noise = np.random.RandomState(1000 + seed).randint(
        -STAGED_NOISE, STAGED_NOISE + 1, (DENSE_HW, DENSE_HW, 3))
    return np.clip(make_image(DENSE_HW, seed) + noise, 0, 255).astype(
        np.uint8)


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
        cold_ms = time_cold_ms(lambda: banded_spmm_cuda(x, band))
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
              f" kernel {ms:.4f} ms (L2-warm; {cold_ms:.4f} ms cold), plain "
              f"{plain_ms:.4f} ms, bmm yardstick {library_ms:.4f} ms (err "
              f"{lib_err:.2e}), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}: {n_bytes / 1e6:.2f} MB, "
              f"{n_ops / 1e9:.3f} GFLOP); bound share "
              f"{rec['bound_ms'] / ms:.3f} warm, {rec['bound_ms'] / cold_ms:.3f}"
              f" cold", flush=True)
        if not ok:
            fail(f"banded_spmm {dtype} disagrees with its plain version")
        if dtype == torch.bfloat16:
            record = rec
    return record


def ring_bound(n: int, chunk: int, elt: int, reduce: bool
               ) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time for K2 (reduce=False)
    or K3 on n ranks of (chunk, HIDDEN) blocks.  K2 reads n blocks and
    writes n^2; K3 reads n^2 and writes n, and adds (n - 1) n chunk HIDDEN
    values, counted at the fp32 rate (bf16 is added in fp32)."""
    e = chunk * HIDDEN * elt
    t_bytes = (n + n * n) * e / PEAK_BYTES_S * 1e3
    n_ops = (n - 1) * n * chunk * HIDDEN if reduce else 0
    t_ops = n_ops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def allocated_beyond_outputs(call) -> tuple[int, list]:
    """(bytes, outputs): how far the peak of the bytes requested from the
    caching allocator over call() rose above the outputs it returned, and
    those outputs.  Requested bytes, not the allocator's blocks, which it
    rounds up and may leave unsplit (a 5.12 MB output can hold a 20 MB
    segment's last 480 KB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    outs = call()
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    return peak - base - sum(o.untyped_storage().nbytes() for o in outs), outs


def check_ring_collectives(dev, n_nodes: int) -> dict:
    """K2 and K3 against their plain versions at the sharded path's shapes
    (PATH_RANKS ranks, chunk = n_nodes / PATH_RANKS rounded up, D = HIDDEN)
    and at the other RING_SIZES over the same nodes, in float32 and
    bfloat16.  Both must agree exactly.  Returns the float32 (the path's
    dtype) records at PATH_RANKS, keyed "K2" and "K3"."""
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
    gen = torch.Generator(device=dev).manual_seed(1)
    records = {}
    for n in RING_SIZES:
        chunk = -(-n_nodes // n)
        rows = n * chunk
        mesh = make_graph_mesh(n)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            blocks = list(x.split(chunk))
            g = torch.randn((n, rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            gs = list(g)
            elt = x.element_size()
            tag = f"n={n} chunk={chunk} D={HIDDEN} {str(dtype)[6:]}"

            # Neither kernel allocates more than its outputs (no receive
            # slots, no scratch).
            extra, out = allocated_beyond_outputs(
                lambda: ring.ring_all_gather_cuda(blocks, mesh))
            if extra > 0:
                fail(f"ring_all_gather allocated {extra} bytes beyond its "
                     f"outputs ({tag})")
            err2 = max(float((o.float() - w.float()).abs().max())
                       for o, w in zip(out, ring.ring_all_gather_plain(blocks)))
            cat = torch.cat(blocks)
            rec2 = {"name": "ring_all_gather", "route": "cuda",
                    "source": "gcn_grabcut_torch/csrc/ring_collectives.cu",
                    "replaces": "gcn_grabcut_tpu/parallel/ring_pallas.py:109",
                    "launches": 0, "max_abs_err": err2,
                    "ms": time_ms(lambda: ring.ring_all_gather_cuda(
                        blocks, mesh)),
                    "plain_ms": time_ms(
                        lambda: ring.ring_all_gather_plain(blocks)),
                    "library_ms": time_ms(
                        lambda: cat.expand(n, rows, HIDDEN).contiguous())}
            rec2["bound_ms"], rec2["bound_by"] = ring_bound(n, chunk, elt,
                                                            False)

            extra, out = allocated_beyond_outputs(
                lambda: ring.ring_reduce_scatter_cuda(gs, mesh))
            if extra > 0:
                fail(f"ring_reduce_scatter allocated {extra} bytes beyond "
                     f"its outputs ({tag})")
            want = ring.ring_reduce_scatter_plain(gs)
            err3 = max(float((o.float() - w.float()).abs().max())
                       for o, w in zip(out, want))
            rec3 = {"name": "ring_reduce_scatter", "route": "cuda",
                    "source": "gcn_grabcut_torch/csrc/ring_collectives.cu",
                    "replaces": "gcn_grabcut_tpu/parallel/ring_pallas.py:194",
                    "launches": 0, "max_abs_err": err3,
                    "ms": time_ms(lambda: ring.ring_reduce_scatter_cuda(
                        gs, mesh)),
                    "plain_ms": time_ms(
                        lambda: ring.ring_reduce_scatter_plain(gs)),
                    "library_ms": time_ms(
                        lambda: g.view(n, n, chunk, HIDDEN).sum(0))}
            rec3["bound_ms"], rec3["bound_by"] = ring_bound(n, chunk, elt,
                                                            True)
            # The yardstick sums in another order: each sum of n terms is
            # within (n - 1) u sum|g| of the exact one (u the unit
            # roundoff), so the two are within 2 n u sum|g|.
            yard = g.view(n, n, chunk, HIDDEN).sum(0).float()
            yard_err = float((yard - torch.stack(want).float()).abs().max())
            u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -8
            yard_tol = 2 * n * u * float(
                g.float().abs().view(n, n, chunk, HIDDEN).sum(0).max())

            mb = chunk * HIDDEN * elt * (n + n * n) / 1e6
            for key, rec, design, yardstick in (
                    ("K2", rec2, "one-shot direct write",
                     "expand().contiguous()"),
                    ("K3", rec3, "one-shot direct read",
                     f"view().sum(0) (err {yard_err:.2e}, tol "
                     f"{yard_tol:.2e})")):
                print(f"{key} {rec['name']} ({design}) {tag}: max_abs_err="
                      f"{rec['max_abs_err']:.1e} kernel {rec['ms']:.4f} ms, "
                      f"plain {rec['plain_ms']:.4f} ms, yardstick "
                      f"{yardstick} {rec['library_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                      f"{mb:.2f} MB)", flush=True)
            if err2 != 0.0 or err3 != 0.0:
                fail(f"ring kernels disagree with their plain versions "
                     f"({tag}: K2 {err2}, K3 {err3})")
            if yard_err > yard_tol:
                fail(f"K3's yardstick disagrees with the ring sum ({tag})")
            if n == PATH_RANKS and dtype == torch.float32:
                records = {"K2": rec2, "K3": rec3}
    return records


def stress_ring_collectives(dev, n_nodes: int) -> None:
    """STRESS_CALLS calls each of K2 and K3 for every ring size, queued
    back to back with fresh seeded data, alternating float32 and bfloat16,
    each with a seeded (rank, phase) delay table (half the entries 0, the
    rest up to STRESS_MAX_DELAY_NS) or none.  Every output must equal its
    plain version bit for bit."""
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
    r = np.random.RandomState(2)
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in RING_SIZES:
        chunk = -(-n_nodes // n)
        rows = n * chunk
        mesh = make_graph_mesh(n)
        checks = []
        t = time.perf_counter()
        for i in range(STRESS_CALLS):
            dtype = (torch.float32, torch.bfloat16)[i % 2]
            delays = [None if i % 5 == 0 else
                      r.randint(0, STRESS_MAX_DELAY_NS, (n, n))
                      * (r.rand(n, n) < 0.5) for _ in range(2)]
            x = torch.randn((rows, HIDDEN), generator=gen, device=dev
                            ).to(dtype)
            outs = ring.ring_all_gather_cuda(list(x.split(chunk)), mesh,
                                             delay_ns=delays[0])
            checks += [(o == x).all() for o in outs]
            gs = list(torch.randn((n, rows, HIDDEN), generator=gen,
                                  device=dev).to(dtype))
            outs = ring.ring_reduce_scatter_cuda(gs, mesh, delay_ns=delays[1])
            checks += [(o == w).all() for o, w in
                       zip(outs, ring.ring_reduce_scatter_plain(gs))]
        bad = int((~torch.stack(checks)).sum())
        print(f"stress n={n} chunk={chunk}: {STRESS_CALLS} calls each of K2 "
              f"and K3 with seeded skew, {len(checks)} rank outputs, "
              f"{bad} inexact ({time.perf_counter() - t:.2f} s)", flush=True)
        if bad:
            fail(f"{bad} ring outputs differ from their plain versions under "
                 f"skew (n={n})")


def graph_on_card(imgs: list, cfg, dev):
    """The port's graph batch of same-size images, built on the card."""
    import gcn_grabcut_torch as gt
    rgbs = torch.as_tensor(np.stack(imgs), device=dev).float()
    out = gt.build_graph_batch_arrays(rgbs, cfg, device=dev)
    return gt.make_graph_batch(
        x=out["x"], edge_src=out["edge_src"], edge_dst=out["edge_dst"],
        edge_attr=out["edge_attr"], node_mask=out["node_mask"],
        edge_mask=out["edge_mask"], node_area=out["node_area"])


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
    g = graph_on_card([img], cfg, dev)
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


def run_sharded_path(dev, records: dict, n_nodes: int) -> None:
    """The graph-sharded forward and its gradient on the main path's graph
    and model: mesh_aggregators over PATH_RANKS ranks with the ring halo."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.models.large import apply_large
    from gcn_grabcut_torch.ops.spmm import banded_spmm
    from gcn_grabcut_torch.parallel import ring

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    g = graph_on_card([make_image(IMAGE_HW)], cfg, dev)
    if g.max_nodes != n_nodes:
        fail(f"the graph has {g.max_nodes} nodes, the kernel phase used "
             f"{n_nodes}")
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED)
                         ).to(dev).eval()
    edges = [a[0].cpu().numpy() for a in (g.edge_src, g.edge_dst,
                                          g.edge_mask)]
    mesh = gt.make_graph_mesh(PATH_RANKS)
    t = time.perf_counter()
    aggs = gt.mesh_aggregators(mesh, *edges, g.max_nodes,
                               method="allgather", halo="pallas_ring")
    setup_s = time.perf_counter() - t
    c = torch.from_numpy(np.random.RandomState(7).randn(
        1, g.max_nodes, 3).astype(np.float32)).to(dev)

    def step(aggs) -> tuple:
        """Forward, then the gradient of sum(logits * c): (logits, grads,
        forward s, backward s, (K2, K3) launch counts after the forward)."""
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model(g, aggregators=aggs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd_counts = (ring.ring_all_gather.kernel_launches,
                      ring.ring_reduce_scatter.kernel_launches)
        (logits * c).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (logits.detach(), {k: p.grad.detach().clone()
                                  for k, p in model.named_parameters()},
                t1 - t0, t2 - t1, fwd_counts)

    step(aggs)                                                   # warm
    banded_spmm.kernel_launches = 0
    ring.ring_all_gather.kernel_launches = 0
    ring.ring_reduce_scatter.kernel_launches = 0
    logits, grads, fwd_s, bwd_s, (k2_fwd, k3_fwd) = step(aggs)
    k2 = ring.ring_all_gather.kernel_launches
    k3 = ring.ring_reduce_scatter.kernel_launches
    k1 = banded_spmm.kernel_launches
    records["K2"]["launches"], records["K3"]["launches"] = k2, k3

    xla_aggs = gt.mesh_aggregators(mesh, *edges, g.max_nodes,
                                   method="allgather", halo="xla")
    step(xla_aggs)                                               # warm
    _, xla_grads, xla_fwd_s, xla_bwd_s, _ = step(xla_aggs)
    ref = apply_large(model, g, precision="highest")
    torch.cuda.synchronize()
    t = time.perf_counter()
    apply_large(model, g, precision="highest")
    torch.cuda.synchronize()
    k1_fwd_s = time.perf_counter() - t

    valid = g.node_mask[0] > 0
    err = float((logits[0][valid] - ref[0][valid]).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    # ctx.attn.bias shifts every score of a softmax alike: its exact
    # gradient is 0, so a parameter's scale is floored at 1e-3 of the
    # model's largest gradient.
    floor = 1e-3 * max(float(v.abs().max()) for v in xla_grads.values())
    grad_err = max(float((grads[k] - v).abs().max())
                   / max(float(v.abs().max()), floor)
                   for k, v in xla_grads.items())
    print(f"sharded path ({PATH_RANKS} ranks of {g.max_nodes // PATH_RANKS}"
          f" nodes, ResGCNNet D={HIDDEN} n={N_LAYERS}, fp32): forward "
          f"{fwd_s * 1e3:.2f} ms, backward {bwd_s * 1e3:.2f} ms (plain halo:"
          f" forward {xla_fwd_s * 1e3:.2f} ms, backward "
          f"{xla_bwd_s * 1e3:.2f} ms; apply_large highest forward "
          f"{k1_fwd_s * 1e3:.2f} ms; edge partition {setup_s:.3f} s); "
          f"ring_all_gather launches={k2} ({k2_fwd} in the forward), "
          f"ring_reduce_scatter launches={k3} ({k3_fwd} in the forward); "
          f"max |dlogits| vs apply_large highest={err:.3e} (tol "
          f"{SHARDED_FWD_TOL * scale:.1e}); worst gradient error vs plain "
          f"halo={grad_err:.3e} of max|grad| (tol {SHARDED_GRAD_TOL:.0e})",
          flush=True)
    if k2_fwd != N_LAYERS + 1 or k2 != k2_fwd:
        fail(f"ring_all_gather launched {k2_fwd} times in the forward and "
             f"{k2 - k2_fwd} in the backward, expected {N_LAYERS + 1} and 0")
    if k3_fwd != 0 or k3 != N_LAYERS + 1:
        fail(f"ring_reduce_scatter launched {k3} times, {k3_fwd} in the "
             f"forward; expected {N_LAYERS + 1}, all in the backward")
    if k1 != 0:
        fail(f"banded_spmm launched {k1} times on the sharded path")
    if logits.shape != (1, g.max_nodes, 3) or not bool(
            torch.isfinite(logits).all()):
        fail("sharded logits are not finite (1, N, 3)")
    if err > SHARDED_FWD_TOL * scale:
        fail("the sharded forward disagrees with apply_large")
    if not grad_err <= SHARDED_GRAD_TOL:
        fail("the ring-halo gradient disagrees with the plain-halo one")


def load_ensemble():
    """(model, meta) of the recommended bgc ensemble, from the checkout's
    checkpoints, on the card."""
    from pathlib import Path

    import gcn_grabcut_torch as gt
    root = Path(__file__).resolve().parent
    return gt.load_model_auto(
        ",".join(str(root / p) for p in DENSE_CHECKPOINTS))


def run_dense_path(dev, card: str) -> None:
    """The recommended configuration: the 3-member bgc ensemble read from
    the checkout's checkpoints, 500 superpixels with the geodesic prior,
    multi-scale trimaps, on DENSE_IMAGES make_image(DENSE_HW) images.
    Held against the port's CPU forward and the JAX package's outputs."""
    import copy
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    root = Path(__file__).resolve().parent
    ref = np.load(root / DENSE_REF)
    model, meta = load_ensemble()
    if meta["ensemble_size"] != len(DENSE_CHECKPOINTS):
        fail(f"loaded an ensemble of {meta['ensemble_size']}")
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    images = [make_image(DENSE_HW, s) for s in range(DENSE_IMAGES)]

    t = time.perf_counter()
    pipe.segment_batch(images[:1], **DENSE_SETTINGS)
    pipe.segment_batch(images, **DENSE_SETTINGS)
    print(f"dense path warm runs (B=1, B={DENSE_IMAGES}): "
          f"{time.perf_counter() - t:.3f} s", flush=True)

    banded_spmm.kernel_launches = 0
    walls1 = []
    for b, img in enumerate(images):
        t = time.perf_counter()
        one = pipe.segment_batch([img], sync_timing=True,
                                 **DENSE_SETTINGS)[0]
        walls1.append(time.perf_counter() - t)
        print(f"  dense B=1 image {b}: {walls1[-1]:.4f} s ({split(one.timing)};"
              f" FG {one.binary_mask.mean():.4f})", flush=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = pipe.segment_batch(images, **DENSE_SETTINGS)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t
    split8 = pipe.segment_batch(images, sync_timing=True,
                                **DENSE_SETTINGS)[0].timing
    k1 = banded_spmm.kernel_launches
    k = res[0].probs.shape[0]
    print(f"dense path timed runs ({DENSE_HW}^2, K={k}, bgc ensemble of "
          f"{meta['ensemble_size']} x ResGCNNet D={HIDDEN} n={N_LAYERS}, "
          f"ms_scales={DENSE_SETTINGS['ms_scales']}; {card}): B=1 median "
          f"{float(np.median(walls1)):.4f} s over {len(walls1)} images; "
          f"B={DENSE_IMAGES} {wall8:.4f} s = {DENSE_IMAGES / wall8:.2f} "
          f"images/s (synchronised split: {split(split8)}); banded_spmm "
          f"launches={k1}", flush=True)
    if k1 != 0:
        fail(f"the dense path launched banded_spmm {k1} times")
    if k > gt.GCNGrabCutPipeline.LARGE_NODE_THRESHOLD:
        fail(f"K={k} took the large-graph path")
    for r in res:
        if r.probs.shape != (k, 3) or not np.isfinite(r.probs).all():
            fail("dense posteriors are not finite (K, 3)")

    # The card's ensemble forward against the CPU's on the same graphs.
    g = graph_on_card(images, cfg, dev)
    probs = pipe._predict_probs_batch(g).cpu()
    g_cpu = gt.make_graph_batch(
        **{f: getattr(g, f).cpu() for f in ("x", "edge_src", "edge_dst",
                                            "edge_attr", "node_mask",
                                            "edge_mask", "node_area")},
        device="cpu")
    ref_cpu = gt.predict_probs(copy.deepcopy(model).cpu(), g_cpu)
    valid = g_cpu.node_mask > 0
    err = float((probs - ref_cpu)[valid].abs().max())
    print(f"dense ensemble posteriors card vs CPU: max |dp|={err:.3e} "
          f"(tol {DENSE_CPU_TOL:.0e})", flush=True)
    if err > DENSE_CPU_TOL:
        fail("the card's ensemble forward disagrees with the CPU's")

    # Against the JAX package (the committed fixture).
    ious, worst_dp = [], 0.0
    for b, r in enumerate(res):
        seg_agree = float((r.segments == ref["segments"][b]).mean())
        a, m = r.binary_mask > 0, ref["mask"][b] > 0
        ious.append(iou(a, m))
        tri_agree = float((r.trimap == ref["trimap"][b]).mean())
        dp = "n/a (labels differ)"
        if seg_agree == 1.0:
            d = float(np.abs(r.probs - ref["probs"][b]).max())
            worst_dp = max(worst_dp, d)
            dp = f"{d:.2e}"
        print(f"  image {b}: SLIC agreement {seg_agree:.6f}, max |dp| "
              f"{dp}, trimap agreement {tri_agree:.6f}, mask IoU vs JAX "
              f"{ious[-1]:.6f} (FG {a.mean():.4f} / {m.mean():.4f})",
              flush=True)
    mean_iou = float(np.mean(ious))
    print(f"dense path vs JAX: mean mask IoU {mean_iou:.6f} (min "
          f"{DENSE_MIN_IOU}), worst posterior difference {worst_dp:.2e} "
          f"(tol {DENSE_JAX_TOL:.0e})", flush=True)
    if mean_iou < DENSE_MIN_IOU:
        fail(f"mean mask IoU against JAX {mean_iou:.4f} < {DENSE_MIN_IOU}")
    if worst_dp > DENSE_JAX_TOL:
        fail("posteriors disagree with JAX where the labels agree")


def unpack_mask(packed: np.ndarray, hw: int) -> np.ndarray:
    return np.unpackbits(packed, count=hw * hw).reshape(hw, hw)


def unpack_trimap(planes: np.ndarray, hw: int) -> np.ndarray:
    return unpack_mask(planes[0], hw) | (unpack_mask(planes[1], hw) << 1)


def iou(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a > 0, b > 0
    return float((a & b).sum() / (a | b).sum()) if (a | b).any() else 1.0


def split(timing: dict) -> str:
    return " ".join(f"{s}={v:.4f}s" for s, v in timing.items())


def run_staged_paths(card: str) -> None:
    """Items 1-5: the staged options, segment_bbox and the GrabCut class
    at the recommended configuration, held against the JAX fixture; the
    native solver against the device solver on the same trimaps."""
    from pathlib import Path

    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch import native
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    root = Path(__file__).resolve().parent
    ref = np.load(root / STAGED_REF)
    if tuple(ref["seeds"]) != STAGED_SEEDS:
        fail(f"{STAGED_REF} holds seeds {ref['seeds']}, not {STAGED_SEEDS}")
    model, _ = load_ensemble()
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    native_pipe = gt.GCNGrabCutPipeline(
        model, cfg, gt.GrabCutConfig(backend="native"))
    t = time.perf_counter()
    native.load()
    print(f"native min-cut build and load: {time.perf_counter() - t:.2f} s",
          flush=True)
    images = [staged_image(s) for s in STAGED_SEEDS]
    pipe.segment(images[0], edge_aware=False, **STAGED_SETTINGS)    # warm

    banded_spmm.kernel_launches = 0
    ious: dict = {}
    for i, (seed, img) in enumerate(zip(STAGED_SEEDS, images)):
        runs = {
            "edge_off": (lambda: pipe.segment(img, edge_aware=False,
                                              **STAGED_SETTINGS), "device"),
            "refine": (lambda: pipe.segment(img, refine_iters=STAGED_REFINE,
                                            **STAGED_SETTINGS), "device"),
            "native": (lambda: native_pipe.segment(img, **STAGED_SETTINGS),
                       "native"),
            "bbox": (lambda: pipe.segment_bbox(img, STAGED_BBOX), "device")}
        for name, (run, backend) in runs.items():
            t = time.perf_counter()
            res = run()
            wall = time.perf_counter() - t
            want = unpack_mask(ref[f"{name}_mask"][i], DENSE_HW)
            want_tri = unpack_trimap(ref[f"{name}_trimap"][i], DENSE_HW)
            ious.setdefault(name, []).append(iou(res.binary_mask, want))
            tri_agree = float((res.trimap == want_tri).mean())
            print(f"  staged {name} seed {seed} ({backend}): {wall:.4f} s "
                  f"({split(res.timing)}); FG {res.binary_mask.mean():.4f} "
                  f"(JAX {want.mean():.4f}); mask IoU vs JAX "
                  f"{ious[name][-1]:.6f}; trimap agreement {tri_agree:.6f}",
                  flush=True)
            if name == "bbox" and tri_agree != 1.0:
                fail(f"segment_bbox's trimap differs from JAX's (seed "
                     f"{seed})")
            if name == "native":
                compare_solvers(img, res.trimap, card)
        for cs in STAGED_COLOUR_SPACES:
            gc = gt.GrabCut(img, gt.GrabCutConfig(color_space=cs))
            t = time.perf_counter()
            first = gc.run_with_bbox(STAGED_BBOX)
            t_box = time.perf_counter() - t
            refined = gc.refine(STAGED_REFINE)
            t_refine = time.perf_counter() - t - t_box
            for step, mask, secs in (("bbox", first, t_box),
                                     ("refine", refined, t_refine)):
                key = f"{cs}_{step}"
                want = unpack_mask(ref[f"{key}_mask"][i], DENSE_HW)
                ious.setdefault(key, []).append(iou(mask, want))
                print(f"  GrabCut {cs} {step} seed {seed} "
                      f"({gc._backend}): {secs:.4f} s; FG {mask.mean():.4f} "
                      f"(JAX {want.mean():.4f}); mask IoU vs JAX "
                      f"{ious[key][-1]:.6f}", flush=True)
            if [h.tag for h in gc.history] != ["bbox_init", "refinement"]:
                fail(f"GrabCut history {[h.tag for h in gc.history]}")
    k1 = banded_spmm.kernel_launches
    worst = min((float(np.mean(v)), k) for k, v in ious.items())
    print(f"staged paths vs JAX ({DENSE_HW}^2, K=484, bgc ensemble; "
          f"{card}): mean mask IoU per item "
          f"{', '.join(f'{k} {np.mean(v):.6f}' for k, v in ious.items())}; "
          f"banded_spmm launches={k1}", flush=True)
    if worst[0] < DENSE_MIN_IOU:
        fail(f"staged item {worst[1]}: mean mask IoU against JAX "
             f"{worst[0]:.4f} < {DENSE_MIN_IOU}")
    if k1 != 0:
        fail(f"the 512 px staged paths launched banded_spmm {k1} times")


def compare_solvers(img: np.ndarray, trimap: np.ndarray, card: str) -> None:
    """The GrabCut class from one trimap with the native solver and with
    the device solver: whole-solve times, and the native min-cuts' own
    host time."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch import native

    cut_s = []
    solve = native.grid_mincut_native

    def timed_cut(*args, **kwargs):
        t = time.perf_counter()
        out = solve(*args, **kwargs)
        cut_s.append(time.perf_counter() - t)
        return out

    native.grid_mincut_native = timed_cut
    try:
        times = {}
        masks = {}
        for backend in ("native", "device"):
            gc = gt.GrabCut(img, gt.GrabCutConfig(backend=backend))
            torch.cuda.synchronize()
            t = time.perf_counter()
            masks[backend] = gc.run_with_trimap(trimap)
            times[backend] = time.perf_counter() - t
    finally:
        native.grid_mincut_native = solve
    n = len(cut_s)
    print(f"  GrabCut solver, same trimap ({card}): native "
          f"{times['native']:.4f} s per solve ({n} host cuts, "
          f"{1e3 * sum(cut_s) / max(n, 1):.2f} ms each), device "
          f"{times['device']:.4f} s per solve; mask IoU native vs device "
          f"{iou(masks['native'], masks['device']):.6f}", flush=True)


def run_stream(card: str) -> None:
    """Item 6: segment_stream against segment_batch on the same chunks,
    beside segment_batch against itself."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    model, _ = load_ensemble()
    pipe = gt.GCNGrabCutPipeline(model, gt.SuperpixelGraphConfig(
        n_segments=DENSE_SEGMENTS, bg_connectivity=True))
    images = [make_image(DENSE_HW, s) for s in STREAM_SEEDS]
    chunks = [images[i:i + STREAM_BATCH]
              for i in range(0, len(images), STREAM_BATCH)]

    def agreement(a, b) -> tuple[float, float]:
        """(least mask pixel agreement, least trimap agreement) over a
        run's images."""
        return (min(float((x.binary_mask == y.binary_mask).mean())
                    for x, y in zip(a, b)),
                min(float((x.trimap == y.trimap).mean())
                    for x, y in zip(a, b)))

    first = pipe.segment_batch(chunks[0], **DENSE_SETTINGS)
    again = pipe.segment_batch(chunks[0], **DENSE_SETTINGS)
    self_agree = agreement(first, again)
    banded_spmm.kernel_launches = 0
    t = time.perf_counter()
    stream = list(pipe.segment_stream(images, batch_size=STREAM_BATCH,
                                      **DENSE_SETTINGS))
    wall = time.perf_counter() - t
    k1 = banded_spmm.kernel_launches
    t = time.perf_counter()
    batch = [r for c in chunks
             for r in pipe.segment_batch(c, **DENSE_SETTINGS)]
    batch_wall = time.perf_counter() - t
    stream_agree = agreement(stream, batch)
    print(f"segment_stream ({len(images)} images in chunks of "
          f"{STREAM_BATCH}; {card}): {wall:.4f} s, segment_batch on the same "
          f"chunks {batch_wall:.4f} s; stream vs batch: least mask agreement "
          f"{stream_agree[0]:.6f}, trimap {stream_agree[1]:.6f}; batch vs "
          f"batch on chunk 0: mask {self_agree[0]:.6f}, trimap "
          f"{self_agree[1]:.6f}; banded_spmm launches={k1}", flush=True)
    if k1 != 0:
        fail(f"segment_stream at {DENSE_HW} px launched banded_spmm {k1} "
             "times")
    if len(stream) != len(images):
        fail(f"segment_stream yielded {len(stream)} of {len(images)} results")
    if stream_agree[0] < self_agree[0] or stream_agree[1] < self_agree[1]:
        fail("segment_stream agrees with segment_batch less than "
             "segment_batch with itself")


def run_predict_probs(card: str) -> None:
    """Item 7: predict_probs(build_graph(...)) on the main path's image and
    model: (K, 3) numpy through the banded SpMM, against segment_batch's
    posteriors on that image."""
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.spmm import banded_spmm

    cfg = gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    model = gt.ResGCNNet(hidden_channels=HIDDEN, n_layers=N_LAYERS,
                         generator=torch.Generator().manual_seed(MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = make_image(IMAGE_HW)
    t = time.perf_counter()
    graph = gt.build_graph(img, cfg)
    build_s = time.perf_counter() - t
    pipe.predict_probs(graph)                                   # warm
    banded_spmm.kernel_launches = 0
    t = time.perf_counter()
    probs = pipe.predict_probs(graph)
    wall = time.perf_counter() - t
    k1 = banded_spmm.kernel_launches
    res = pipe.segment_batch([img])[0]
    seg_agree = float((res.segments == graph.segments).mean())
    differ = res.segments != graph.segments
    same = np.ones(graph.n_nodes, bool)
    same[res.segments[differ]] = False
    same[graph.segments[differ]] = False
    valid = (graph.node_mask > 0) & same
    dp = float(np.abs(probs - res.probs)[valid].max())
    print(f"predict_probs(RegionGraph) ({IMAGE_HW}^2, K={graph.n_nodes}, "
          f"ResGCNNet D={HIDDEN} n={N_LAYERS}; {card}): build_graph "
          f"{build_s:.4f} s, predict_probs {wall:.4f} s, banded_spmm "
          f"launches={k1}; vs segment_batch: SLIC agreement {seg_agree:.6f}, "
          f"max |dp| {dp:.3e} on {int(valid.sum())} nodes (tol "
          f"{PREDICT_TOL:.0e}), exactly equal: "
          f"{bool(np.array_equal(probs, res.probs))}", flush=True)
    if not isinstance(probs, np.ndarray) or probs.shape != (graph.n_nodes, 3):
        fail("predict_probs did not return (K, 3) numpy")
    if k1 != N_LAYERS + 1:
        fail(f"predict_probs launched banded_spmm {k1} times, expected "
             f"{N_LAYERS + 1}")
    if seg_agree < 0.999 or dp > PREDICT_TOL:
        fail("predict_probs disagrees with segment_batch's posteriors")


def check_keep_largest_repeats(dev) -> None:
    """Keep-largest's component sums run in a fixed order: repeated runs
    on one mask give bit-identical sums and masks."""
    from gcn_grabcut_torch.ops.connected import (_clean_mask,
                                                 connected_components)
    from gcn_grabcut_torch.ops.region import segment_sum
    hw = DENSE_HW
    yy, xx = np.mgrid[0:hw, 0:hw]
    mask = np.zeros((hw, hw), np.uint8)
    for cy, cx, r in ((200, 220, 110), (420, 100, 50), (90, 430, 40),
                      (400, 400, 60)):
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 1
    mask[:, :6] = 1                                 # a frame-like strip
    rng = np.random.RandomState(11)
    post = (0.5 + 0.5 * rng.rand(hw, hw)).astype(np.float32)
    m = torch.from_numpy(mask).to(dev)
    p = torch.from_numpy(post).to(dev)
    labels = connected_components(m > 0).long().reshape(-1).clamp_max(
        hw * hw - 1)
    planes = torch.stack([torch.ones(hw * hw, device=dev), p.reshape(-1)], 1)
    min_area = 0.002 * hw * hw
    outs, sums = [], []
    t = time.perf_counter()
    for _ in range(KEEP_LARGEST_REPEATS):
        outs.append(_clean_mask(m, min_area, True, p))
        sums.append(segment_sum(labels, planes, hw * hw))
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t) / KEEP_LARGEST_REPEATS
    same_mask = all(torch.equal(o, outs[0]) for o in outs)
    same_sums = all(torch.equal(s_, sums[0]) for s_ in sums)
    cpu = _clean_mask(m.cpu(), min_area, True, p.cpu())
    cpu_sums = segment_sum(labels.cpu(), planes.cpu(), hw * hw)
    print(f"keep-largest fixed-order sums ({hw}^2 mask, "
          f"{int(torch.unique(labels).numel()) - 1} components): "
          f"{KEEP_LARGEST_REPEATS} repeats, masks identical {same_mask}, "
          f"sums identical {same_sums}; equal to the CPU's: mask "
          f"{bool(torch.equal(outs[0].cpu(), cpu))}, sums "
          f"{bool(torch.equal(sums[0].cpu(), cpu_sums))}; "
          f"{per_call * 1e3:.2f} ms per clean-up and sum", flush=True)
    if not (same_mask and same_sums):
        fail("keep-largest's sums differ between runs")


def flat_image(hw: int) -> np.ndarray:
    """Uniform colour regions and a uniform disc."""
    img = np.empty((hw, hw, 3), np.uint8)
    img[:] = (70, 90, 120)
    img[2 * hw // 3:] = (60, 110, 50)
    img[:, : hw // 5] = (140, 120, 100)
    yy, xx = np.mgrid[0:hw, 0:hw]
    img[(yy - hw // 2) ** 2 + (xx - int(hw * 0.55)) ** 2 < (hw // 5) ** 2] = (
        220, 60, 40)
    return img


def run_flat_colour(card: str) -> None:
    """Open fault 1: a flat-colour image through the dense path on the card
    and on the CPU (the port on both).  Reported, not gated: the std-Lab
    feature cancels in float32 on uniform regions."""
    import copy

    import gcn_grabcut_torch as gt

    model, _ = load_ensemble()
    cfg = gt.SuperpixelGraphConfig(n_segments=DENSE_SEGMENTS,
                                   bg_connectivity=True)
    img = flat_image(DENSE_HW)
    card_res = gt.GCNGrabCutPipeline(model, cfg).segment_batch(
        [img], **DENSE_SETTINGS)[0]
    t = time.perf_counter()
    cpu_res = gt.GCNGrabCutPipeline(copy.deepcopy(model).cpu(), cfg,
                                    device="cpu").segment_batch(
        [img], **DENSE_SETTINGS)[0]
    cpu_s = time.perf_counter() - t
    seg_agree = float((card_res.segments == cpu_res.segments).mean())
    dp = float(np.abs(card_res.probs - cpu_res.probs).max())
    print(f"flat-colour image through the dense path, card vs CPU ({card}; "
          f"the CPU run {cpu_s:.1f} s): SLIC agreement {seg_agree:.6f}; max "
          f"|dp| {dp:.3e} over {card_res.probs.shape[0]} nodes; trimap "
          f"pixels differing {int((card_res.trimap != cpu_res.trimap).sum())}"
          f", mask pixels differing "
          f"{int((card_res.binary_mask != cpu_res.binary_mask).sum())} of "
          f"{DENSE_HW * DENSE_HW}; FG {card_res.binary_mask.mean():.4f} / "
          f"{cpu_res.binary_mask.mean():.4f}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    import gcn_grabcut_torch as gt     # fails outside the checkout
    from gcn_grabcut_torch import kernels
    from gcn_grabcut_torch.graph_build import num_nodes_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
          f"{card}", flush=True)
    print(optional_packages(), flush=True)

    t = time.perf_counter()
    libs = kernels.build()
    print(f"kernel build: {time.perf_counter() - t:.2f} s "
          f"({', '.join(sorted(libs))})", flush=True)

    k = num_nodes_for(IMAGE_HW, IMAGE_HW,
                      gt.SuperpixelGraphConfig(n_segments=N_SEGMENTS))

    record = check_banded_spmm(dev)
    rings = check_ring_collectives(dev, k)
    stress_ring_collectives(dev, k)
    run_main_path(dev, record)
    run_sharded_path(dev, rings, k)
    run_dense_path(dev, card)
    check_keep_largest_repeats(dev)
    run_flat_colour(card)
    run_staged_paths(card)
    run_stream(card)
    run_predict_probs(card)

    print(json.dumps({"kernels": [record, rings["K2"], rings["K3"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
