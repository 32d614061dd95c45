#!/usr/bin/env python3
"""Where the port's main path spends the card's time.

    python3 profile_port.py            # the main path under torch.profiler
    python3 profile_port.py --dense    # the dense B=8 target: its stages
                                       # and its graph build's busy share,
                                       # launches, host syncs, top kernels
    python3 profile_port.py --kernels  # what holds the min-cut, K1, K2,
                                       # K3 and the segment sum back, and
                                       # the banded GAT attention
    python3 profile_port.py --build-kernels [DIR ...]
                                       # the connectivity and mask
                                       # components kernels, their variants
                                       # and other checkouts' designs

Runs chip_smoke.py's main-path configuration on one GPU (a 1536x1536
synthetic image, 10 000 SLIC segments, the seeded ResGCNNet at D=128,
n_layers=6, B=1): a warm run and a timed run of segment_batch, then the
same call, and its GrabCut stage alone, under torch.profiler recording
device activity only.  For each it prints the unprofiled wall time, the
device's busy time (the union of its activity intervals) and busy share,
the number of device activities, and the heaviest kernels.  Profiling
slows the host, not the kernels, so busy time is set against the
unprofiled wall time.

With --kernels it first times the min-cut kernel (csrc/grid_mincut.cu)
on the main path's first GrabCut iteration at 1536^2, as built and in
variants of its tiles, loads and occupancy (CUT_VARIANTS; one turns on
the in-kernel tallies and timers of push sweeps and relabels, which the
committed build leaves out), beside its
bytes bound, its barrier floor (its grid-wide barriers times an empty
barrier's time on the same grid) and the plain version, and profiles the
GrabCut stage alone (wall, device busy share).  Then it times K1 (bf16,
the path's shapes), K2 and K3 (float32,
n = 2, 4, 8 ranks over the path's 10 000 rows) as built and in variants
that each take one piece out or change one choice: each variant is the
committed source with textual edits (K2's TMA bulk copy, the design
measured first, is the largest), built by nvcc into
gcn_grabcut_torch/_build/variants/ and timed as chip_smoke.py times the
kernels (device time per call, warm L2).  Variants that skip work give
wrong outputs and only say what that work costs; each K2 line says whether
the variant's output was exact.  The segment-sum kernel is timed the
same way at chip_smoke.py's timed fixed-order sums cases (the call sites'
real values, random values, an adversarial long segment): as built, with
tiles of 256, 512 and 1024 rows for every row width, without skipping
identity rows, with columns spread over 2x fewer units, with 4 rows in
flight per thread instead of 16, with its walks' adds taken out, capped at
85 registers a thread, with its walks staged by cp.async (two stages of
14 KB, or of 7 KB), as two grids, and as the design before its long blocks
(profile_kernels/segment_sum_block_path.cu).  It times that design's
wrapper and kernel against the current ones on the paths that make many
short sums (host_cost: the wrapper's host time per call, the sharded
forward and backward, a training step).  Then it profiles one
full-width GAT attention layer (128 -> 8 heads of 16,
chip_smoke.gat_layer_case) on the main path's 10 000-node graph: banded at
"default" and "highest" and as the edge list, each call's wall time,
device busy time and busy share, its launches of the segment-sum kernel
(csrc/segment_sum.cu) and its heaviest kernels; and the main path's
segment_batch under the profiler, then its clean-up's connected_components
and component sums, each alone on the same mask.

With --build-kernels it times the connectivity kernel
(csrc/slic_connectivity.cu) and the mask components kernel
(csrc/mask_components.cu) on chip_smoke.py phase 17's cases (their inputs
recorded at the dense and large cells' call sites, and the cap cases): as
built and in variants (SLIC_VARIANTS, MASK_VARIANTS; two turn on the
in-kernel stage timers, which the committed build leaves out), each with
its bits against the plain version and its tallies, and the designs of the
checkouts named after the flag (each a directory holding its own
gcn_grabcut_torch/, e.g. a `git archive` of a parent commit unpacked into a
git-ignored directory), each run in a process of its own before and after
this checkout's on the same inputs.  Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
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
# Edits of csrc/ring_collectives.cu that K2 and K3 share.
FENCED_EXIT = ("fence.sc.sys before the exit release",
               [("  if (threadIdx.x == 0) st_release_sys(word, epoch);\n}",
                 "  if (threadIdx.x == 0) {\n    __threadfence_system();\n"
                 "    st_release_sys(word, epoch);\n  }\n}")])
GPU_SCOPE = ("gpu scope (one card only)", [(".sys.global", ".gpu.global")])
NO_WAITS = ("no waits (unsafe)",
            [("  wait_peers(t, n, r, b, epoch);\n", ""),
             ("  wait_peers(t, n, r, (long long)sig_stride + b, epoch);\n",
              "")])
# K2's copy through the TMA unit, the design measured first: one thread
# per block loads 8 KB pieces of its slice into a ring of 4 shared-memory
# buffers (1-D cp.async.bulk, counted on mbarriers) and issues n bulk
# stores of each piece; 32 KB of dynamic shared memory per block.
BULK_HELPERS = """\
constexpr int PIECE = 8192;   // bytes, a multiple of 16
constexpr int RING = 4;

// TMA bulk copies for K2.  Addresses and sizes are multiples of 16 bytes.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// Until the barrier's phase of this parity has completed, bounded.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  long long spins = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\\n.reg .pred p;\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
        "selp.u32 %0, 1, 0, p;\\n}\\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (++spins > MAX_SPINS) __trap();
  }
}

// Global -> shared; the barrier's phase ends when the bytes have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared -> global, in the current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

// Piece p of a slice of `bytes`: PIECE bytes, the last one what is left.
__device__ __forceinline__ unsigned piece_bytes(long long bytes, int p) {
  const long long left = bytes - (long long)p * PIECE;
  return (unsigned)(left < PIECE ? left : PIECE);
}

// Thread 0's copy of vectors [v0, v1) of rank r's block to slot r of every
// rank's output, through RING buffers of PIECE bytes: piece p goes through
// buffer p % RING, whose mbarrier completes phase (p / RING) & 1 when the
// piece has landed.  Returns once every store is complete and ordered
// before this thread's later generic accesses.
__device__ void push_slice(const RingTable& t, int n, int r, long long vecs,
                           long long v0, long long v1, char* ring,
                           unsigned long long* full) {
  const long long bytes = (v1 - v0) * 16;
  const int pieces = (int)((bytes + PIECE - 1) / PIECE);
  const char* src = reinterpret_cast<const char*>(t.in[r] + v0);
  const long long dst = ((long long)r * vecs + v0) * 16;   // in every out_j
  auto load = [&](int p) {
    bulk_load(ring + (p % RING) * PIECE, src + (long long)p * PIECE,
              piece_bytes(bytes, p), &full[p % RING]);
  };
  for (int s = 0; s < RING; ++s) mbar_init(&full[s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  // The peers' entry words (acquired before the block's barrier), then the
  // async-proxy stores into their outputs.
  asm volatile("fence.proxy.async.global;" ::: "memory");
  for (int p = 0; p < pieces && p < RING; ++p) load(p);
  for (int p = 0; p < pieces; ++p) {
    const char* buf = ring + (p % RING) * PIECE;
    mbar_wait(&full[p % RING], (p / RING) & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const unsigned size = piece_bytes(bytes, p);
    for (int j = 0; j < n; ++j)
      bulk_store(reinterpret_cast<char*>(t.out[j]) + dst +
                     (long long)p * PIECE, buf, size);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // Once piece p - 1's stores have read its buffer, the buffer's next
    // piece loads while piece p is stored.
    if (p >= 1 && p - 1 + RING < pieces) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(p - 1 + RING);
    }
  }
  // Complete, not only read out of shared memory; then the exit release.
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

"""
BULK_COPY = [
    ("// K2.  vecs = 16-byte vectors per chunk;",
     BULK_HELPERS + "// K2.  vecs = 16-byte vectors per chunk;"),
    ("  const long long own = (long long)r * vecs;\n"
     "  for (long long v = v0 + threadIdx.x;",
     "  extern __shared__ __align__(128) char ring[];\n"
     "  __shared__ unsigned long long full[RING];\n"
     "  if (threadIdx.x == 0) push_slice(t, n, r, vecs, v0, v1, ring, "
     "full);\n"
     "  const long long own = (long long)r * vecs;\n"
     "  for (long long v = v1;"),                 # the vector copy runs dry
    ("THREADS, 0);", "THREADS, RING * PIECE);"),
    ("dim3(THREADS), args, 0,", "dim3(THREADS), args, RING * PIECE,"),
]
K2_VARIANTS = [
    ("as built", []),
    FENCED_EXIT,
    GPU_SCOPE,
    NO_WAITS,
    ("launch only", [("  constexpr int U = 8;   // vectors a thread keeps in "
                      "flight\n", "  if (n > 0) return;\n  constexpr int U = "
                      "8;   // vectors a thread keeps in flight\n")]),
    ("4 vectors a thread", [("constexpr int U = 8;   // vectors a thread",
                             "constexpr int U = 4;   // vectors a thread")]),
    ("4 blocks per SM", [("(per_sm < 2 ? per_sm : 2)",
                          "(per_sm < 4 ? per_sm : 4)")]),
    ("TMA bulk copy (8 KB pieces, a 4-buffer ring)", BULK_COPY),
    ("TMA bulk copy, 4 KB pieces",
     BULK_COPY + [("constexpr int PIECE = 8192;",
                   "constexpr int PIECE = 4096;")]),
    ("TMA bulk copy without its proxy fences (unsafe)",
     BULK_COPY + [('  asm volatile("fence.proxy.async.global;" ::: '
                   '"memory");\n', ""),
                  ('    asm volatile("fence.proxy.async.shared::cta;" ::: '
                   '"memory");\n', "")]),
]
K3_VARIANTS = [
    ("as built", []),
    FENCED_EXIT,
    ("entry word released, not relaxed",
     [("st_relaxed_sys(t.sig[r] + b, epoch);",
       "st_release_sys(t.sig[r] + b, epoch);")]),
    GPU_SCOPE,
    NO_WAITS,
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


def variant_source(name: str, label: str, edits) -> str:
    """csrc/<name>.cu with the variant's edits; raises if an edit's text
    is not in the source."""
    from gcn_grabcut_torch import kernels
    src = (kernels.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {label!r}: {old!r} not in "
                               f"{name}.cu")
        src = src.replace(old, new)
    return src


def build_variants(name: str, variants, tag: str) -> list:
    """[(variant name, ctypes library)], one nvcc per variant, in parallel."""
    from gcn_grabcut_torch import kernels
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, edits) in enumerate(variants):
        cu = out_dir / f"{tag}_{i}.cu"
        cu.write_text(variant_source(name, label, edits))
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
    """K1, K2 and K3 as built and in the variants above, device ms per
    call."""
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
    for label, lib in build_variants("banded_spmm", K1_VARIANTS, "k1"):
        fn = lib.banded_spmm_bf16
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        ms = cs.time_ms(lambda: fn(band.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), n_pad, n, R, K, cs.HIDDEN,
                                   stream))
        print(f"K1 bf16 n_pad={n_pad} R={R} K={K} D={cs.HIDDEN}, {label}: "
              f"{ms:.4f} ms", flush=True)

    def ring_call(fn, tables, n_ranks, chunk_bytes, mesh):
        def call():
            err = fn(*tables, n_ranks, chunk_bytes, SIGNAL_BLOCKS,
                     mesh.next_epoch(), None, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return call

    k2_libs = build_variants("ring_collectives", K2_VARIANTS, "k2")
    k3_libs = build_variants("ring_collectives", K3_VARIANTS, "k3")
    for n_ranks in cs.RING_SIZES:
        chunk = -(-n // n_ranks)
        mesh = make_graph_mesh(n_ranks)
        chunk_bytes = chunk * cs.HIDDEN * 4
        tag = f"f32 n={n_ranks} chunk={chunk} D={cs.HIDDEN}"
        blocks = list(torch.randn((n_ranks * chunk, cs.HIDDEN),
                                  device=dev).split(chunk))
        want = torch.cat(blocks)
        gathered = [torch.empty_like(want) for _ in blocks]
        tables = [ring._table(t) for t in (blocks, gathered,
                                           list(mesh.signals))]
        for label, lib in k2_libs:
            for o in gathered:
                o.zero_()
            ms = cs.time_ms(ring_call(ring._bind(lib.ring_all_gather),
                                      tables, n_ranks, chunk_bytes, mesh))
            exact = all(torch.equal(o, want) for o in gathered)
            print(f"K2 {tag}, {label}: {ms:.4f} ms (exact: {exact})",
                  flush=True)

        gs = list(torch.randn((n_ranks, n_ranks * chunk, cs.HIDDEN),
                              device=dev))
        outs = [torch.empty((chunk, cs.HIDDEN), device=dev) for _ in gs]
        tables = [ring._table(t) for t in (gs, outs, list(mesh.signals))]
        for label, lib in k3_libs:
            ms = cs.time_ms(ring_call(ring._bind(lib.reduce_scatter_f32),
                                      tables, n_ranks, chunk_bytes, mesh))
            print(f"K3 {tag}, {label}: {ms:.4f} ms", flush=True)


def segment_tile(rows: int) -> tuple:
    """An edit of csrc/segment_sum.cu that sets every call's tile."""
    return ("  const cudaStream_t s = (cudaStream_t)stream;\n",
            f"  const cudaStream_t s = (cudaStream_t)stream;\n"
            f"  tile = {rows};\n")


# The walk's vectors staged by cp.async (4, 8 or 16 bytes; 2-byte vectors
# by a load and a store) into two stages, chunk c + 1's copies in flight
# while chunk c is added, in place of the loaders' register loads and
# st.shared.  Shared memory grows by one stage (14 KB) for every block of
# the launch, the per-thread path's included.
STAGE_COPY = """\
// One vector global -> shared: cp.async where it is 4, 8 or 16 bytes.
template <typename VT>
__device__ __forceinline__ void stage_copy(VT* dst, const VT* src) {
  if constexpr (sizeof(VT) >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                    "n"(sizeof(VT)) : "memory");
  } else {
    *dst = *src;
  }
}

// A maximum of long segment s for group g's column vectors"""
CP_ASYNC = [
    ("// A maximum of long segment s for group g's column vectors",
     STAGE_COPY),
    ("  Vec<T, V> stage[STAGE_BYTES / (V * sizeof(T))];\n};",
     "  Vec<T, V> stage[2][STAGE_BYTES / (V * sizeof(T))];\n};"),
    ("        if (j < chunk && k0 + j < K)\n"
     "          x[i] = reinterpret_cast<const VT*>(\n"
     "              base + (int64_t)buf[j] * a.C)[e - j * nvec];\n"
     "      }\n    };",
     "        if (j < chunk && k0 + j < K)\n"
     "          stage_copy(&sm.stage[buf == sm.row[0] ? 0 : 1][e],\n"
     "                     reinterpret_cast<const VT*>(\n"
     "                         base + (int64_t)buf[j] * a.C) + (e - j * nvec));\n"
     "      }\n"
     "      asm volatile(\"cp.async.commit_group;\" ::: \"memory\");\n    };"),
    ("        if (li >= 0 && j < chunk && k0 + j < K) sm.stage[e] = x[i];\n"
     "      }\n",
     "      }\n"
     "      asm volatile(\"cp.async.wait_all;\" ::: \"memory\");\n"),
    ("      const VT* st = sm.stage;", "      const VT* st = sm.stage[c & 1];"),
]
# The long blocks and the per-thread blocks as two grids on one stream, the
# long one first (the launch's blocks split at long_blocks).
TWO_GRIDS = [
    ("  int64_t long_blocks;\n",
     "  int64_t long_blocks, first;   // first: the grid's first block\n"),
    ("  const int64_t b = blockIdx.x;\n",
     "  const int64_t b = blockIdx.x + a.first;\n"),
    ("""  if (a.perm)
    segment_reduce_kernel<T, V, MAX, true><<<(unsigned)blocks, THREADS, 0,
                                             stream>>>(a);
  else
    segment_reduce_kernel<T, V, MAX, false><<<(unsigned)blocks, THREADS, 0,
                                              stream>>>(a);
""", """  auto grid = [&](int64_t first, int64_t count) {
    if (count <= 0) return;
    Args<T> g = a;
    g.first = first;
    if (a.perm)
      segment_reduce_kernel<T, V, MAX, true><<<(unsigned)count, THREADS, 0,
                                               stream>>>(g);
    else
      segment_reduce_kernel<T, V, MAX, false><<<(unsigned)count, THREADS, 0,
                                                stream>>>(g);
  };
  grid(0, a.long_blocks);
  grid(a.long_blocks, blocks - a.long_blocks);
"""),
]
# Variants of csrc/segment_sum.cu: (name, edits).  The design before the
# long blocks (one block streamed each long segment's chain, and only where
# rows were 16-byte vectors) is a source of its own, SEGMENT_BLOCK_PATH,
# with its own C interface.
SEGMENT_VARIANTS = [
    ("as built (tiles of 256 rows for rows of 256 bytes or more, else 1024)",
     []),
    ("tiles of 256 rows", [segment_tile(256)]),
    ("tiles of 512 rows", [segment_tile(512)]),
    ("tiles of 1024 rows", [segment_tile(1024)]),
    ("no skipping (identity rows added)",
     [("  return id;\n}", "  return id && false;\n}")]),
    ("columns spread 2x less (groups of 64 bytes)",
     [("constexpr int GROUP_BYTES = 32;", "constexpr int GROUP_BYTES = 64;")]),
    ("4 rows in flight per thread, not 16",
     [("constexpr int DEEP = 16;", "constexpr int DEEP = 4;")]),
    ("walks without their adds (wrong sums)",
     [("        auto add = [&](const VT* y) {\n",
       "        auto add = [&](const VT* y) {\n          if (rows >= 0) return;\n")]),
    ("at most 85 registers a thread (3 blocks an SM)",
     [("__launch_bounds__(THREADS) segment_reduce_kernel",
       "__launch_bounds__(THREADS, 3) segment_reduce_kernel")]),
    ("walks staged by cp.async, two stages of 14 KB", CP_ASYNC),
    ("walks staged by cp.async, two stages of 7 KB (the same shared memory)",
     CP_ASYNC + [("constexpr int LOADER_BYTES = 64;",
                  "constexpr int LOADER_BYTES = 32;")]),
    ("two grids, the long blocks' first", TWO_GRIDS),
]
SEGMENT_BLOCK_PATH = "profile_kernels/segment_sum_block_path.cu"


def build_block_path():
    """The block-path design's library (SEGMENT_BLOCK_PATH), built as the
    variants are."""
    from gcn_grabcut_torch import kernels
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "segment_block_path.so"
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                           str(so), SEGMENT_BLOCK_PATH],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{SEGMENT_BLOCK_PATH} failed to build:\n"
                           f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def segment_call(lib, vals, segs, out, op: str, stream):
    """A call of a variant's segment_reduce (the current C interface) with
    scratch for every tile and group layout a variant may have (tiles of
    256 rows, one group per column vector)."""
    from gcn_grabcut_torch.ops import region
    fn = lib.segment_reduce
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong] + [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 4
    rows = vals.shape[0]
    cols = vals.numel() // max(rows, 1)
    plan = region.kernel_plan(rows, cols, segs.n, vals.element_size(),
                              vals.data_ptr() % 16 == 0
                              and out.data_ptr() % 16 == 0)
    most = plan.cv * -(-rows // region.THREADS)
    keep = torch.empty(plan.cv * rows, dtype=torch.int32, device=vals.device)
    count = torch.empty(most, dtype=torch.int32, device=vals.device)
    done = torch.zeros(most, dtype=torch.int32, device=vals.device)
    perm = None if segs.order is None else segs.order.data_ptr()

    def call():
        err = fn(region._DTYPE_CODES[vals.dtype], region._OPS[op], plan.vec,
                 plan.tile, vals.data_ptr(), perm, segs.ordered.data_ptr(),
                 segs.offsets.data_ptr(), out.data_ptr(), rows, segs.n, cols,
                 keep.data_ptr(), count.data_ptr(), done.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def block_path_call(lib, vals, segs, out, op: str, stream):
    """A call of the block-path design's segment_reduce."""
    from gcn_grabcut_torch.ops import region
    fn = lib.segment_reduce
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    perm = None if segs.order is None else segs.order.data_ptr()
    cols = vals.numel() // max(vals.shape[0], 1)

    def call():
        err = fn(region._DTYPE_CODES[vals.dtype], region._OPS[op],
                 vals.data_ptr(), perm, segs.offsets.data_ptr(),
                 out.data_ptr(), segs.n, cols, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def segment_variants() -> None:
    """The segment-sum kernel as built, in SEGMENT_VARIANTS and as the
    block-path design, at chip_smoke's timed fixed-order sums cases (real,
    random and adversarial values), device ms per call, each output held
    to the plain version bit for bit."""
    import chip_smoke as cs
    from gcn_grabcut_torch.ops import region

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases, _ = cs.segment_cases(dev)
    libs = build_variants("segment_sum", SEGMENT_VARIANTS, "seg")
    block_path = build_block_path()
    for name, case in cases.items():
        if not case.timed:
            continue
        segs = region.Segments(case.index, case.n, case.is_sorted)
        want = region.segment_reduce_plain(case.values, segs, case.op)
        out = torch.empty_like(want)
        calls = [(label, segment_call(lib, case.values, segs, out, case.op,
                                      stream)) for label, lib in libs]
        calls.append(("the block-path design", block_path_call(
            block_path, case.values, segs, out, case.op, stream)))
        for variant, call in calls:
            out.zero_()
            call()
            exact = cs.same_bits(out, want)
            print(f"segment_sum {name} ({case.label}), {variant}: "
                  f"{cs.time_ms(call):.4f} ms (exact: {exact})", flush=True)


def block_path_segment_reduce(lib):
    """The block-path design's wrapper (ops/region.py segment_reduce_cuda
    at commit 33bdaee) around its library: the checks, the
    output, the argument types set at every call, no scratch."""
    from gcn_grabcut_torch.ops import region

    def segment_reduce_cuda(values, segs, op):
        if (values.device.type != "cuda"
                or segs.offsets.device != values.device):
            raise ValueError("values and segments on one CUDA device")
        if values.dtype not in region._DTYPE_CODES:
            raise TypeError(f"no kernel for {values.dtype}")
        if op not in region._OPS:
            raise ValueError(f"unknown reduction {op!r}")
        if values.dim() < 1 or values.shape[0] != segs.index.shape[0]:
            raise ValueError("values do not match the index")
        if not values.is_contiguous():
            raise ValueError("values must be contiguous")
        out = torch.empty((segs.n,) + values.shape[1:], dtype=values.dtype,
                          device=values.device)
        if out.numel() == 0:
            return out
        fn = lib.segment_reduce
        fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 \
            + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        perm = None if segs.order is None else segs.order.data_ptr()
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            err = fn(region._DTYPE_CODES[values.dtype], region._OPS[op],
                     values.data_ptr(), perm, segs.offsets.data_ptr(),
                     out.data_ptr(), segs.n, region._flat(values).shape[1],
                     stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        region.segment_sum.kernel_launches += 1
        return out
    return segment_reduce_cuda


#: Calls per wrapper timing, and runs per path timing (the median is kept).
HOST_CALLS, HOST_REPS = 200, 15


def host_cost() -> None:
    """The segment sum's wrapper and kernel as built against the
    block-path design's (block_path_segment_reduce) in one process, on the paths that make many
    short sums: the wrapper's host microseconds per call (queued, no sync),
    the 4-rank sharded forward and backward at 1536^2 / 10k, and one fp32
    training step of ResGCNNet and of GCNTrimapNet (8 graphs at 512^2 /
    500, numpy-seeded weights), host wall ms with a sync after each, the
    median of HOST_REPS.  The designs run as built, block path, block
    path, as built."""
    import chip_smoke as cs
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops import region
    from gcn_grabcut_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    built = region.segment_reduce_cuda
    designs = {"as built": built,
               "the block-path design's wrapper and kernel":
                   block_path_segment_reduce(
                   build_block_path())}
    order = list(designs) + list(designs)[::-1]

    def each(label: str, fn, unit: str) -> None:
        """fn() -> (numbers, launches) under each design in `order`."""
        got: dict = {name: [] for name in designs}
        for name in order:
            region.segment_reduce_cuda = designs[name]
            try:
                numbers, launches = fn()
            finally:
                region.segment_reduce_cuda = built
            got[name].append(numbers)
        for name, runs in got.items():
            print(f"host cost, {label}, {name}: " + "; ".join(
                ", ".join(f"{k} {v:.4f} {unit}" for k, v in r.items())
                for r in runs) + f" (segment_sum launches {launches})",
                flush=True)

    r = np.random.RandomState(0)
    for label, (rows, cols, n) in {
            "wrapper, 27 333 x 128 into 2 500 (long blocks planned)":
                (27_333, 128, 2_500),
            "wrapper, 200 x 8 into 40 (no long blocks)": (200, 8, 40)}.items():
        segs = region.Segments(torch.as_tensor(r.randint(0, n, rows),
                                               device=dev), n)
        vals = torch.randn((rows, cols), device=dev)

        def calls():
            fn = region.segment_reduce_cuda
            for _ in range(20):
                fn(vals, segs, "sum")
            torch.cuda.synchronize()
            region.segment_sum.kernel_launches = 0
            t = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn(vals, segs, "sum")
            host = (time.perf_counter() - t) / HOST_CALLS
            torch.cuda.synchronize()
            return ({"host per call": host * 1e6},
                    region.segment_sum.kernel_launches)
        each(label, calls, "us")

    cfg = gt.SuperpixelGraphConfig(n_segments=cs.N_SEGMENTS)
    g = cs.graph_on_card([cs.make_image(cs.IMAGE_HW)], cfg, dev)
    model = gt.ResGCNNet(
        hidden_channels=cs.HIDDEN, n_layers=cs.N_LAYERS,
        generator=torch.Generator().manual_seed(cs.MODEL_SEED)).to(dev).eval()
    edges = [a[0].cpu().numpy() for a in (g.edge_src, g.edge_dst,
                                          g.edge_mask)]
    aggs = gt.mesh_aggregators(gt.make_graph_mesh(cs.PATH_RANKS), *edges,
                               g.max_nodes, method="allgather",
                               halo="pallas_ring")
    c = torch.randn((1, g.max_nodes, 3), device=dev)

    def sharded():
        fwd, bwd = [], []
        for _ in range(HOST_REPS + 1):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            region.segment_sum.kernel_launches = 0
            t0 = time.perf_counter()
            logits = model(g, aggregators=aggs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            launches = region.segment_sum.kernel_launches
            (logits * c).sum().backward()
            torch.cuda.synchronize()
            fwd.append(t1 - t0)
            bwd.append(time.perf_counter() - t1)
        return ({"forward": 1e3 * float(np.median(fwd[1:])),
                 "backward": 1e3 * float(np.median(bwd[1:]))}, launches)
    each(f"sharded path ({cs.PATH_RANKS} ranks, 1536^2 / 10k, ResGCNNet "
         f"D={cs.HIDDEN} n={cs.N_LAYERS}, fp32; launches in the forward)",
         sharded, "ms")

    samples = gt.make_hard_synthetic_dataset(cs.TRAIN_GRAPHS, cs.DENSE_HW,
                                             seed=cs.EVAL_SEED + 1)
    graphs = [x[0] for x in gt.prepare_dataset(samples, gt.SuperpixelGraphConfig(
        n_segments=cs.DENSE_SEGMENTS, bg_connectivity=True))]
    tcfg = TrainConfig(bf16=False, prior_dropout=0.0, weight_decay=3e-4,
                       batch_size=cs.TRAIN_GRAPHS, verbose=False)
    tmp = tempfile.TemporaryDirectory()
    for variant in ("resgcn", "gcn"):
        tr = Trainer(variant, dict(hidden_channels=cs.HIDDEN,
                                   n_layers=cs.N_LAYERS, dropout=0.0),
                     tcfg, save_dir=tmp.name, device=dev)
        batch = tr._bucket(graphs)
        tr._init_state(1)
        gt.init_model_numpy(tr.model, cs.VARIANT_SEED)
        w = torch.ones(batch.n_graphs, device=dev)

        def train_step(tr=tr, batch=batch, w=w):
            steps = []
            for _ in range(HOST_REPS + 1):
                torch.cuda.synchronize()
                region.segment_sum.kernel_launches = 0
                t = time.perf_counter()
                loss, grads = tr.loss_and_grads(batch, w)
                tr.optimizer.step(grads)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t)
            return ({"step": 1e3 * float(np.median(steps[1:]))},
                    region.segment_sum.kernel_launches)
        each(f"training step ({variant} D={cs.HIDDEN} n={cs.N_LAYERS}, "
             f"{cs.TRAIN_GRAPHS} graphs at {cs.DENSE_HW}^2 / "
             f"{cs.DENSE_SEGMENTS}, fp32; launches per step)", train_step,
             "ms")
    tmp.cleanup()


def cleanup_profile() -> None:
    """The main path's segment_batch at 1536^2 / 10k under the profiler,
    then its clean-up's two parts on the same image's mask, each alone:
    connected_components and the component sums."""
    import chip_smoke as cs
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.ops.connected import connected_components
    from gcn_grabcut_torch.ops.region import segment_sum

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
    print("segment_batch stages: " + " ".join(
        f"{k}={v:.3f}s" for k, v in res.timing.items()), flush=True)
    report("segment_batch (1536^2 / 10k)", wall,
           lambda: pipe.segment_batch([img]))

    dev = torch.device("cuda")
    hw = cs.IMAGE_HW * cs.IMAGE_HW
    mask = torch.as_tensor(res.binary_mask[None], device=dev) > 0
    post = torch.rand((hw,), device=dev)

    def components():
        return connected_components(mask).long().reshape(-1)

    labels = components()
    clamped = labels.clamp_max(hw - 1)
    valid = (labels < hw).float()
    planes = torch.stack([valid, valid, post * valid], 1)
    for label, fn in (("connected_components", components),
                      ("the component sums (segment_sum, 3 planes)",
                       lambda: segment_sum(clamped, planes, hw))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        report(f"clean-up on the main path's mask (FG "
               f"{float(mask.float().mean()):.4f}): {label}",
               time.perf_counter() - t, fn)


# Min-cut kernel variants: (name, [(text in csrc/grid_mincut.cu,
# replacement)]).
# Edits that turn on the min-cut's in-kernel tallies and timers.
CUT_STATS = ("#include <cooperative_groups.h>",
             "#define GRID_MINCUT_STATS\n#include <cooperative_groups.h>")
# Edits that make a block start each tile's loads into one of two sweep
# windows and then sweep its previous tile in the other, so that the next
# window loads while this one sweeps (cp.async groups).
CUT_PREFETCH = [
    ("""  asm volatile("cp.async.wait_all;\\n" ::: "memory");
}
""", """  asm volatile("cp.async.wait_all;\\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\\n" :: "n"(N) : "memory");
}
"""),
    ("      SWEEP_BYTES > RELAX_BYTES ? SWEEP_BYTES : RELAX_BYTES;",
     "      2 * SWEEP_BYTES > RELAX_BYTES ? 2 * SWEEP_BYTES : RELAX_BYTES;"),
    ("""  uint8_t* now = s.quiet[k & 1];
  each_tile(""", """  uint8_t* now = s.quiet[k & 1];
  long long pat = -1, pbase = 0;
  int py0 = 0, px0 = 0, pw = 0;
  auto sweep = [&]() {
    const bool quiet = sweep_window<ND>(
        s, sp, hn, pbase, py0, px0,
        Window<ND>(sm + pw * Tiles<ND>::SWEEP_BYTES));
    if (threadIdx.x == 0) {
      now[pat] = quiet && k > 0;
      ++t.swept;
      if (quiet) stat(t.quiet);
    }
  };
  each_tile("""),
    ("""    load_window<ND>(s, sp, h, base, y0, x0, Window<ND>(sm));
    cp_async_wait();
    __syncthreads();
    // Sweep 0 reads the caller's planes, which may hold -0: its output
    // differs from its input there.
    const bool quiet =
        sweep_window<ND>(s, sp, hn, base, y0, x0, Window<ND>(sm));
    if (threadIdx.x == 0) {
      now[at] = quiet && k > 0;
      ++t.swept;
      if (quiet) stat(t.quiet);
    }
  });
""", """    const int w = pat >= 0 ? pw ^ 1 : 0;
    load_window<ND>(s, sp, h, base, y0, x0,
                    Window<ND>(sm + w * Tiles<ND>::SWEEP_BYTES));
    cp_async_commit();
    if (pat >= 0) {
      cp_async_wait_group<1>();
      __syncthreads();
      sweep();
    }
    pat = at;
    pbase = base;
    py0 = y0;
    px0 = x0;
    pw = w;
  });
  if (pat >= 0) {
    cp_async_wait_group<0>();
    __syncthreads();
    sweep();
  }
"""),
]
CUT_TILE_32x16 = ("constexpr int TILE_H = 32, TILE_W = 32;",
                  "constexpr int TILE_H = 32, TILE_W = 16;")
CUT_VARIANTS = [
    ("as built", []),
    ("as built, with the in-kernel tallies and timers (GRID_MINCUT_STATS)",
     [CUT_STATS]),
    ("next tile's window prefetched by cp.async while this one sweeps "
     "(two windows, one block a SM)", CUT_PREFETCH),
    ("sweep tile 32 x 16", [CUT_TILE_32x16]),
    ("sweep tile 32 x 16, next tile's window prefetched (two windows, two "
     "blocks a SM)", [CUT_TILE_32x16, *CUT_PREFETCH]),
    ("tile loads through registers (ld.global.cg), not cp.async",
     [("""  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n"
               :: "r"(s), "l"(src) : "memory");""",
       """  (void)s;
  *reinterpret_cast<unsigned*>(dst) =
      __ldcg(reinterpret_cast<const unsigned*>(src));""")]),
    ("3 blocks a SM (registers capped at 80 by the launch bounds)",
     [("__launch_bounds__(THREADS, 2) grid_mincut_kernel",
       "__launch_bounds__(THREADS, 3) grid_mincut_kernel")]),
    ("no quiet tile skipped (each swept, quiet ones adding +0)",
     [("    if (j > 0) {\n      bool busy = false;",
       "    if (false) {\n      bool busy = false;")]),
    ("no relax tile skipped (each relaxes its steps)",
     [("        if (sub > 0) {", "        if (false) {")]),
    ("every tile swept in full (no quiet-window shortcut, no skip)",
     [("    if (j > 0) {\n      bool busy = false;",
       "    if (false) {\n      bool busy = false;"),
      ("  if (!__syncthreads_or(active)) {",
       "  if (!__syncthreads_or(true)) {")]),
    ("sweep tile 32 x 64 (rows x columns: halo share 1.30, not 1.41; "
     "one block a SM)",
     [("constexpr int TILE_H = 32, TILE_W = 32;",
       "constexpr int TILE_H = 32, TILE_W = 64;")]),
    ("relax tile 32 x 64 (not 32 x 32)",
     [("constexpr int RELAX_H = 32, RELAX_W = 32;",
       "constexpr int RELAX_H = 32, RELAX_W = 64;")]),
]


def variant_solve(lib, problem) -> tuple:
    """One solve of `problem` (excess, r_fwd, r_bwd, options) by a
    variant's build of the kernel on fresh copies: (fg, e, planes, grid,
    ctrl), ctrl the kernel's tallies, on the card."""
    from gcn_grabcut_torch.ops import maxflow as mf
    excess, r_fwd, r_bwd, kw = problem
    e, rf, rb = mf.working_copies(excess, r_fwd, r_bwd)
    fg, ctrl, grid = mf.grid_mincut_cuda(
        e, rf, rb, kw.get("connectivity", 8), kw.get("max_outer", 400),
        mf._n_sweeps(kw.get("sweeps_per_round", 48), kw.get("unroll", 4)),
        kw.get("relabel_iters"), kw.get("unroll", 4), lib=lib)
    return fg, e, rf + rb, grid, ctrl


def mincut_kernel() -> None:
    """The min-cut kernel on the main path's first GrabCut iteration at
    1536^2: as built and in CUT_VARIANTS (device ms per solve, bits
    against the plain version), its tallies, bytes bound and barrier floor
    (chip_smoke.mincut_case), the plain version's wall time; then the
    GrabCut stage alone under the profiler: wall, device busy share."""
    import chip_smoke as cs
    import gcn_grabcut_torch as gt
    from gcn_grabcut_torch.grabcut import grabcut_batch_device
    from gcn_grabcut_torch.ops import maxflow as mf

    cfg = gt.SuperpixelGraphConfig(n_segments=cs.N_SEGMENTS)
    model = gt.ResGCNNet(
        hidden_channels=cs.HIDDEN, n_layers=cs.N_LAYERS,
        generator=torch.Generator().manual_seed(cs.MODEL_SEED))
    pipe = gt.GCNGrabCutPipeline(model, cfg)
    img = cs.make_image(cs.IMAGE_HW)
    res = pipe.segment_batch([img])[0]
    rgbs = torch.as_tensor(img[None], device=pipe.device).float()
    trimaps = torch.as_tensor(res.trimap[None], device=pipe.device)
    problem = cs.recorded_solves(grabcut_batch_device, rgbs, trimaps)[0]
    cs.mincut_case("large cell, iteration 1", *problem, card=cs.gpu_line())
    want = mf.grid_mincut_plain(*problem[:3], **problem[3])
    for label, lib in build_variants("grid_mincut", CUT_VARIANTS, "cut"):
        got = variant_solve(lib, problem)
        same = all(cs.same_bits(a, b) for a, b in zip(
            (got[0], got[1], *got[2]), (want[0], want[1], *want[2],
                                        *want[3])))
        ms = cs.time_ms(lambda: variant_solve(lib, problem), reps=3,
                        warmup=1)
        grid, tally = got[3], mf.kernel_tally(got[4])
        stats = ""
        if tally["sweep_us"]:
            stats = (f"; in the kernel {tally['sweep_us'] / 1e3:.3f} ms of "
                     f"push sweeps, {tally['relabel_us'] / 1e3:.3f} ms of "
                     f"relabels; quiet tiles swept {tally['quiet_tiles']} "
                     f"of {tally['swept_tiles']}, relax tiles skipped "
                     f"{tally['relax_skipped']} (relaxed "
                     f"{tally['relax_tiles']})")
        print(f"  min-cut variant {label}: {ms:.4f} ms, bits "
              f"{'equal' if same else 'DIFFER'}; {grid['blocks_per_sm']} "
              f"blocks a SM, {grid['registers']} registers, "
              f"{grid['smem_bytes']} B of shared memory a block{stats}",
              flush=True)

    def stage():
        grabcut_batch_device(rgbs, trimaps, pipe.gc_config)

    stage()
    torch.cuda.synchronize()
    mf.grid_mincut_cuda.kernel_launches = 0
    t = time.perf_counter()
    stage()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    report(f"GrabCut stage, large cell (1536^2; "
           f"{mf.grid_mincut_cuda.kernel_launches} min-cut launches)", wall,
           stage)


# Connectivity kernel (csrc/slic_connectivity.cu) variants: (name,
# [(text in the source, replacement)]).  Each gives the same labels.
SLIC_STATS = ("#include <cooperative_groups.h>",
              "#define SLIC_CONNECTIVITY_STATS\n"
              "#include <cooperative_groups.h>")
SLIC_SUPER_16 = ("constexpr int SUPER = 8;", "constexpr int SUPER = 16;")
SLIC_VARIANTS = [
    ("as built", []),
    ("with the stage timers (SLIC_CONNECTIVITY_STATS)", [SLIC_STATS]),
    ("super-blocks of 16 steps", [SLIC_SUPER_16]),
    ("super-blocks of 16 steps, with the stage timers",
     [SLIC_SUPER_16, SLIC_STATS]),
    ("no tile skipped (every tile runs every pass)",
     [("      const int n_active = k == 0 ? tiles : ld(j.tcount + k % 3);",
       "      const int n_active = k == 0 || ld(j.tcount + k % 3) ? tiles "
       ": 0;"),
      ("      const int n_active = a == 0 ? tiles : ld(j.tcount + kk % 3);",
       "      const int n_active = a == 0 || ld(j.tcount + kk % 3) ? tiles "
       ": 0;"),
      ("    const int tl = all ? take : ld(j.active[k & 1] + take);",
       "    const int tl = take;")]),
    ("absorption passes of 1 round", [("constexpr int ABS_ROUNDS = 2;",
                                       "constexpr int ABS_ROUNDS = 1;")]),
    ("super-blocks of 4 steps, absorption passes of 1 round",
     [("constexpr int SUPER = 8;", "constexpr int SUPER = 4;"),
      ("constexpr int ABS_ROUNDS = 2;", "constexpr int ABS_ROUNDS = 1;")]),
]
# Mask components kernel (csrc/mask_components.cu) variants.
MASK_VARIANTS = [
    ("as built", []),
    ("with the pass timers (MASK_COMPONENTS_STATS)",
     [("#include <cooperative_groups.h>",
       "#define MASK_COMPONENTS_STATS\n#include <cooperative_groups.h>")]),
]
# Where build_kernels leaves phase 17's inputs for another checkout's run.
BUILD_INPUTS = "phase17_inputs.pt"


def time_build_cases(label: str, repairs: dict, labellings: dict,
                     slic_libs=((None, None),),
                     mask_libs=((None, None),)) -> None:
    """Each case of chip_smoke phase 17 through the gcn_grabcut_torch on
    sys.path (this checkout's or another's): for each build of the
    connectivity kernel in slic_libs and of the mask components kernel in
    mask_libs ((variant name, library), None for the package's own), the
    device ms per call, its bits against the plain version, and its
    tallies (`kernel_tally` where the package has one)."""
    import chip_smoke as cs
    from gcn_grabcut_torch.ops import connected as cc
    from gcn_grabcut_torch.ops import slic as slic_ops

    def tally(mod, ctrl):
        if hasattr(mod, "kernel_tally"):
            return mod.kernel_tally(ctrl)
        return mod.kernel_loops(ctrl) if mod is slic_ops else {
            "sweeps": int(ctrl[-1])}

    for variant, lib in slic_libs:
        if hasattr(slic_ops, "kernel_grid"):
            print(f"  A, {label}{', ' + variant if variant else ''}: grid "
                  f"{slic_ops.kernel_grid(lib)}", flush=True)
    for name, (labels, k, absorb, sweeps) in repairs.items():
        want = slic_ops.absorb_orphans_plain(labels, absorb)
        if sweeps:
            want = slic_ops.enforce_connectivity_plain(want, k, sweeps)
        for variant, lib in slic_libs:
            kw = {} if lib is None else {"lib": lib}

            def call():
                return slic_ops.repair_connectivity_cuda(labels, k, absorb,
                                                         sweeps, **kw)

            same = torch.equal(call(), want)
            info = tally(slic_ops, slic_ops.repair_connectivity_cuda.last_ctrl)
            ms = cs.time_ms(call, reps=10, warmup=2)
            print(f"  A, {label}{', ' + variant if variant else ''}: {name}: "
                  f"{ms:.4f} ms, bits {'equal' if same else 'DIFFER'}; "
                  f"{info}", flush=True)
    for name, (mask, conn, iters) in labellings.items():
        want = cc.connected_components_plain(mask, conn, iters)
        for variant, lib in mask_libs:
            kw = {} if lib is None else {"lib": lib}

            def call():
                return cc.connected_components_cuda(mask, conn, iters, **kw)

            same = torch.equal(call(), want)
            info = tally(cc, cc.connected_components_cuda.last_ctrl)
            ms = cs.time_ms(call, reps=10, warmup=2)
            print(f"  B, {label}{', ' + variant if variant else ''}: {name}: "
                  f"{ms:.4f} ms, bits {'equal' if same else 'DIFFER'}; "
                  f"{info}", flush=True)


def build_kernels(others: list) -> None:
    """The connectivity and mask components kernels on chip_smoke phase
    17's cases (build_kernel_inputs): this checkout's as built and in
    SLIC_VARIANTS and MASK_VARIANTS, and before and after them the
    package of each checkout in `others` (a directory holding
    gcn_grabcut_torch/, its kernels built there) in a process of its own
    on the same inputs, so that the designs are compared in one call."""
    import chip_smoke as cs
    from gcn_grabcut_torch import kernels

    dev = torch.device("cuda")
    repairs, labellings, _ = cs.build_kernel_inputs(dev)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = kernels.BUILD_DIR / BUILD_INPUTS
    torch.save({"repairs": {n: (c[0].cpu(), *c[1:])
                            for n, c in repairs.items()},
                "labellings": {n: (c[0].cpu(), *c[1:])
                               for n, c in labellings.items()}}, path)

    def others_run(when: str) -> None:
        for d in others:
            print(f"the design at {d} ({when}):", flush=True)
            subprocess.run([sys.executable, __file__, "--time-build-kernels",
                            str(path), d], check=True)

    others_run("first")
    slic_libs = build_variants("slic_connectivity", SLIC_VARIANTS, "slic")
    mask_libs = build_variants("mask_components", MASK_VARIANTS, "mask")
    print("this checkout's design:", flush=True)
    time_build_cases("this checkout", repairs, labellings, slic_libs,
                     mask_libs)
    others_run("again, last")


def time_build_kernels(inputs: str, package: str) -> None:
    """build_kernels' run of another checkout's package, in this process:
    its kernels on the saved inputs."""
    package = os.path.abspath(package)
    sys.path.insert(0, package)
    import gcn_grabcut_torch
    if not gcn_grabcut_torch.__file__.startswith(package):
        raise RuntimeError(f"imported {gcn_grabcut_torch.__file__}, not the "
                           f"package under {package}")
    dev = torch.device("cuda")
    saved = torch.load(inputs)
    time_build_cases(
        package,
        {n: (c[0].to(dev), *c[1:]) for n, c in saved["repairs"].items()},
        {n: (c[0].to(dev), *c[1:]) for n, c in saved["labellings"].items()})


def gat_attention() -> None:
    """The banded GAT attention layer at 10k nodes under the profiler, as
    the edge list beside it: the evidence for or against a fused kernel
    (ROADMAP M5)."""
    import chip_smoke as cs
    from gcn_grabcut_torch.ops.region import segment_sum
    _, g, layer, args, plan = cs.gat_layer_case(torch.device("cuda"))
    for label, kw in (("banded default", dict(plan=plan)),
                      ("banded highest", dict(plan=plan,
                                              plan_precision="highest")),
                      ("edge-list", {})):
        def call(kw=kw):
            with torch.no_grad():
                layer(*args, pre_sorted=True, **kw)
        call()
        torch.cuda.synchronize()
        segment_sum.kernel_launches = 0
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        report(f"GAT attention layer, {label} (K={g.max_nodes}, "
               f"E={g.max_edges}; segment_sum launches "
               f"{segment_sum.kernel_launches})", wall, call)


def dense_target(device=None, hw: int | None = None,
                 n_images: int | None = None):
    """The dense B=8 target: the recommended configuration (the 3-member
    bgc ensemble of chip_smoke.DENSE_CHECKPOINTS, 500 superpixels with
    bg_connectivity, chip_smoke.DENSE_SETTINGS: ms_scales (1.0, 0.75)) on
    n_images make_image(hw, s) images (default 8 at 512 px).  Returns
    (pipeline, images, segment_batch settings)."""
    from pathlib import Path

    import chip_smoke as cs
    import gcn_grabcut_torch as gt

    hw = cs.DENSE_HW if hw is None else hw
    n_images = cs.DENSE_IMAGES if n_images is None else n_images
    root = Path(__file__).resolve().parent
    model, _ = gt.load_model_auto(
        ",".join(str(root / p) for p in cs.DENSE_CHECKPOINTS), device=device)
    pipe = gt.GCNGrabCutPipeline(model, gt.SuperpixelGraphConfig(
        n_segments=cs.DENSE_SEGMENTS, bg_connectivity=True), device=device)
    images = [cs.make_image(hw, s) for s in range(n_images)]
    return pipe, images, dict(cs.DENSE_SETTINGS)


def host_syncs(fn) -> int:
    """The host syncs fn() makes: the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def dense_profile() -> None:
    """The dense B=8 target's segment_batch (stage split, synchronised) and
    its graph build, the full-scale build and the 0.75-scale rebuild each
    alone: wall time, device busy share, device activities (launches),
    host syncs and heaviest kernels."""
    import chip_smoke as cs
    from gcn_grabcut_torch.graph_build import build_graph_batch_arrays
    from gcn_grabcut_torch.ops import image as im

    torch.backends.cuda.matmul.allow_tf32 = False
    pipe, images, settings = dense_target()
    pipe.segment_batch(images, **settings)                     # warm
    t = time.perf_counter()
    res = pipe.segment_batch(images, sync_timing=True, **settings)[0]
    batch_wall = time.perf_counter() - t
    print(f"dense B={len(images)} segment_batch ({cs.DENSE_HW}^2, "
          f"{settings}): {batch_wall:.3f} s = {len(images) / batch_wall:.2f}"
          f" images/s "
          f"synchronised; stages: " + " ".join(
              f"{k}={v:.4f}s" for k, v in res.timing.items()), flush=True)
    rgbs = torch.as_tensor(np.stack(images), device=pipe.device).float()
    hw = max(int(round(cs.DENSE_HW * 0.75)), 64)
    rgbs75 = im.resize_bilinear(rgbs, (hw, hw))
    for label, x in (("full scale", rgbs), ("0.75-scale rebuild", rgbs75)):
        def build():
            return build_graph_batch_arrays(x, pipe.sp_config,
                                            device=pipe.device)
        build()
        torch.cuda.synchronize()
        t = time.perf_counter()
        build()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        syncs = host_syncs(build)
        report(f"graph build, dense B={len(images)} {label} ({syncs} host "
               f"syncs)", wall, build)
    report(f"segment_batch, dense B={len(images)}", batch_wall,
           lambda: pipe.segment_batch(images, **settings))


def main() -> None:
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", flush=True)
        sys.exit(1)
    if "--dense" in sys.argv[1:]:
        import chip_smoke as cs
        print(f"torch {torch.__version__}, {cs.gpu_line()}", flush=True)
        dense_profile()
        return
    if sys.argv[1:2] == ["--time-build-kernels"]:
        time_build_kernels(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--build-kernels"]:
        import chip_smoke as cs
        print(f"torch {torch.__version__}, {cs.gpu_line()}", flush=True)
        build_kernels(sys.argv[2:])
        return
    if "--kernels" in sys.argv[1:]:
        import chip_smoke as cs
        print(f"torch {torch.__version__}, {cs.gpu_line()}", flush=True)
        mincut_kernel()
        kernel_variants()
        segment_variants()
        host_cost()
        gat_attention()
        cleanup_profile()
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
