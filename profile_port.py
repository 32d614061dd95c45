#!/usr/bin/env python3
"""Where the port's main path spends the card's time.

    python3 profile_port.py            # the main path under torch.profiler
    python3 profile_port.py --kernels  # what holds K1 and K3 back

Runs chip_smoke.py's main-path configuration on one GPU (a 1536x1536
synthetic image, 10 000 SLIC segments, the seeded ResGCNNet at D=128,
n_layers=6, B=1): a warm run and a timed run of segment_batch, then the
same call, and its GrabCut stage alone, under torch.profiler recording
device activity only.  For each it prints the unprofiled wall time, the
device's busy time (the union of its activity intervals) and busy share,
the number of device activities, and the heaviest kernels.  Profiling
slows the host, not the kernels, so busy time is set against the
unprofiled wall time.

With --kernels it times K1 (bf16, the path's shapes) and K3 (float32, n =
2, 4, 8 ranks) as built and in variants that each take one piece out or
change one choice: each variant is the committed source with one textual
edit, built by nvcc into gcn_grabcut_torch/_build/variants/ and timed as
chip_smoke.py times the kernels (device time per call, warm L2).  Variants
that skip work give wrong outputs and only say what that work costs.  Needs
CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time

import torch

# K1 variants: (name, [(text in csrc/banded_spmm.cu, replacement)]).
K1_VARIANTS = [
    ("as built", []),
    ("no wgmma (TMA loads and stores only)",
     [("    c.step(st, st + P::A_ELTS);\n    __syncthreads();",
       "    if (n_pad < 0) c.step(st, st + P::A_ELTS);\n    __syncthreads();")]),
    ("launch only", [("  constexpr unsigned TX =",
                      "  if (R > 0) return;\n  constexpr unsigned TX =")]),
]
# K3 variants, edits of csrc/ring_collectives.cu.
K3_VARIANTS = [
    ("as built", []),
    ("fence.sc.sys before the exit release",
     [("  if (threadIdx.x == 0) st_release_sys(word, epoch);\n}",
       "  if (threadIdx.x == 0) {\n    __threadfence_system();\n"
       "    st_release_sys(word, epoch);\n  }\n}")]),
    ("entry word released, not relaxed",
     [("st_relaxed_sys(t.sig[r] + b, epoch);",
       "st_release_sys(t.sig[r] + b, epoch);")]),
    ("gpu scope (one card only)",
     [(".sys.global", ".gpu.global"), ("__threadfence_system()",
                                       "__threadfence()")]),
    ("no waits (unsafe)",
     [("  wait_peers(t, n, r, b, epoch);\n", ""),
      ("  wait_peers(t, n, r, (long long)sig_stride + b, epoch);\n", "")]),
    ("launch only", [("   // vectors per batch\n",
                      "   // vectors per batch\n  if (n > 0) return;\n")]),
]


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


def build_variants(name: str, variants) -> list:
    """[(variant name, ctypes library)], one nvcc per variant, in parallel."""
    from gcn_grabcut_torch import kernels
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (kernels.CSRC / f"{name}.cu").read_text()
    procs = []
    for i, (label, edits) in enumerate(variants):
        src = base
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {label!r}: {old!r} not in "
                                   f"{name}.cu")
            src = src.replace(old, new)
        cu = out_dir / f"{name}_{i}.cu"
        cu.write_text(src)
        procs.append((label, cu.with_suffix(".so"), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for label, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {label!r} failed to build:\n{log}")
        libs.append((label, ctypes.CDLL(str(so))))
    return libs


def kernel_variants() -> None:
    """K1 and K3 as built and in the variants above, device ms per call."""
    import chip_smoke as cs
    from gcn_grabcut_torch.models.large import build_gcn_plans_device
    from gcn_grabcut_torch.parallel import ring
    from gcn_grabcut_torch.parallel.mesh import SIGNAL_BLOCKS, make_graph_mesh

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    side = int(round(cs.N_SEGMENTS ** 0.5))
    n = side * side
    src, dst = (torch.as_tensor(a, device=dev)
                for a in cs.slic_like_edges(side, 4, seed=0))
    plan, _ = build_gcn_plans_device(src, dst, torch.ones(src.shape,
                                                          device=dev), n,
                                     dtype=torch.bfloat16)
    band = plan.band
    K, n_pad, R = band.shape
    x = torch.randn((n, cs.HIDDEN), device=dev).to(torch.bfloat16)
    out = torch.empty((n_pad, cs.HIDDEN), device=dev)
    for label, lib in build_variants("banded_spmm", K1_VARIANTS):
        fn = lib.banded_spmm_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        ms = cs.time_ms(lambda: fn(band.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), n_pad, n, R, K, cs.HIDDEN,
                                   stream))
        print(f"K1 bf16 n_pad={n_pad} R={R} K={K} D={cs.HIDDEN}, {label}: "
              f"{ms:.4f} ms", flush=True)

    libs = build_variants("ring_collectives", K3_VARIANTS)
    for n_ranks in cs.RING_SIZES:
        chunk = -(-n // n_ranks)
        mesh = make_graph_mesh(n_ranks)
        gs = list(torch.randn((n_ranks, n_ranks * chunk, cs.HIDDEN),
                              device=dev))
        outs = [torch.empty((chunk, cs.HIDDEN), device=dev) for _ in gs]
        tables = [ring._table(t) for t in (gs, outs, list(mesh.signals))]
        for label, lib in libs:
            fn = lib.reduce_scatter_f32
            fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 3
                           + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_ulonglong,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            ms = cs.time_ms(lambda: fn(*tables, n_ranks,
                                       chunk * cs.HIDDEN * 4, SIGNAL_BLOCKS,
                                       mesh.next_epoch(), None, stream))
            print(f"K3 f32 n={n_ranks} chunk={chunk} D={cs.HIDDEN}, {label}: "
                  f"{ms:.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", flush=True)
        sys.exit(1)
    if "--kernels" in sys.argv[1:]:
        import chip_smoke as cs
        print(f"torch {torch.__version__}, {cs.gpu_line()}", flush=True)
        kernel_variants()
        return
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
