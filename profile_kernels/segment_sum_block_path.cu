// The segment-sum kernel's design before its long blocks (one block
// streamed a long segment's whole chain, and only where rows were
// 16-byte vectors), kept for profile_port.py --kernels to time beside
// gcn_grabcut_torch/csrc/segment_sum.cu.  Not built by the package.
//
// Fixed-order segment sum and segment max for Hopper (sm_90a): the port's
// sums by index (ops/region.py segment_sum, segment_max) on the card.
//
// Replaces no Pallas kernel.  In the JAX package these sums are XLA's
// jax.ops.segment_sum / segment_max and .at[].add (ops/region.py,
// core/scatter.py, models/layers.py, parallel/partition.py), which a TPU
// runs in one order in every run.  On the card a float index_add_ adds with
// atomics, in no fixed order, and torch.segment_reduce needs lengths, which
// torch.bincount gives only after a host sync.
//
// What it computes.  Given the rows of `values` (P, C), an order `perm` of
// them (null: the rows are already sorted) and the (n + 1) offsets of n
// segments in that order, for every segment s and column c:
//
//   sum:  out[s, c] = (((0 + v[r0, c]) + v[r1, c]) + ...)    r0 < r1 < ...
//   max:  out[s, c] = max over the same rows, -inf for an empty segment,
//
// where rk = perm[offsets[s] + k]: a sequential chain of adds in ascending
// row order starting from 0, the order of the plain version (a stable sort,
// then torch.segment_reduce), of index_add_ on the CPU and so of the JAX
// package's segment_sum on its CPU.  Accumulation is the plain version's:
// float32 and float64 add in their own type; bfloat16 and float16 widen to
// float32, add, and round back to nearest even after every add (c10's
// BFloat16 and Half operator+, which segment_reduce applies per element).
// The max is max(acc, x) = acc < x ? x : acc, a NaN taking over: exact in
// any order, so for it the kernel removes only the host sync.
//
// Bound.  The kernel must read values (P C elt), the index (P int64, here
// the permutation; for sorted rows the searchsorted that made the offsets
// read it) and the offsets ((n + 1) int64), and write the output (n C elt):
// bytes over 3.35 TB/s on an H100.  The adds, P C, are far below the
// card's rate at every shape of the port.
//
// Design: simple and right first.  One thread owns one segment and a run
// of V columns (V = 16 bytes of the element type when C is a multiple of V
// and both base pointers are 16-byte aligned, else 1) and loops the
// segment's rows in order, so the chain's order is fixed by construction
// and no thread waits on another.  Neighbouring threads take neighbouring
// column runs of one segment, then the next segment's, so a warp reads one
// row's columns in one coalesced transaction.
//   Wide case (C = 128, short segments: the GAT messages and the sharded
//   aggregation, ~10 rows a segment): float32 gives 32 threads of 16-byte
//   loads per segment, one warp reading a 512-byte row per step;
//   bfloat16 two segments a warp.
//   Narrow case (C = 6 or 15 with ~230 pixels a segment at 1536^2 / 10 000
//   superpixels: SLIC and the region statistics, unsorted): one thread per
//   (segment, column), 2 to 5 segments a warp, each step one 24- or 60-byte
//   row per segment.  Only n C threads exist (~150 000, about half of the
//   card's resident threads), each with a chain of ~230 dependent adds, so
//   it is bound by latency, not bytes.
// Each thread starts DEEP (16) rows' loads before it adds any of them while
// its segment has that many rows left, then SHORT (4), then one, so the
// loads overlap while the adds keep their order.  Reading rows through
// `perm` gathers them in place: no sorted copy of the values is written.
//   Long segments.  One segment can be far longer than the rest: the
//   port's padded edges all point at node 0 (~52 000 of the GAT layer's
//   160 000 edges at 1536^2 / 10 000) and the banded GAT's fallback list
//   ends in one masked tail.  Walked by one warp, such a chain is bound by
//   that warp's loads in flight (~5 ms for 26 MB) while the card idles.  So
//   where a row is whole 16-byte vectors, a segment of more than LONG_ROWS
//   rows is left by the per-thread grid to a second grid of LONG_BLOCKS
//   blocks, each of which takes such segments whole: all 256 threads stream
//   the rows through shared memory (cp.async, 96 KB in flight) and one
//   thread per column vector adds them in the same order.  The chain stays
//   one thread's, so the order, and the bits, are the per-thread path's.
// Nothing is reduced across threads, so there are no atomics and no
// second pass.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DEEP = 16;     // rows in flight per thread while 16 remain
constexpr int SHORT = 4;     // ... then while 4 remain
// The block path: segments of more rows than LONG_ROWS, with 16-byte
// column vectors, are summed by whole blocks, STAGES stages of STAGE_BYTES
// in flight through shared memory.
constexpr int64_t LONG_ROWS = 512;
constexpr int LONG_BLOCKS = 132;   // one per SM of an H100
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 32 * 1024;
constexpr int LONG_SMEM = STAGES * STAGE_BYTES;

// The accumulator type and the rounding back to the element type.
template <typename T> struct Elt;
template <> struct Elt<float> {
  using Acc = float;
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float a) { return a; }
};
template <> struct Elt<double> {
  using Acc = double;
  __device__ static double widen(double x) { return x; }
  __device__ static double narrow(double a) { return a; }
};
template <> struct Elt<__nv_bfloat16> {
  using Acc = float;
  __device__ static float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 narrow(float a) {
    return __float2bfloat16_rn(a);
  }
};
template <> struct Elt<__half> {
  using Acc = float;
  __device__ static float widen(__half x) { return __half2float(x); }
  __device__ static __half narrow(float a) { return __float2half_rn(a); }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, bool MAX>
__device__ __forceinline__ typename Elt<T>::Acc step(typename Elt<T>::Acc acc,
                                                     T x) {
  const typename Elt<T>::Acc w = Elt<T>::widen(x);
  if (MAX) return isnan(w) ? w : (acc < w ? w : acc);
  return Elt<T>::widen(Elt<T>::narrow(acc + w));   // round as the element
}

// Adds the segment's rows from r on to acc, U at a time while U remain (the
// U loads started before their adds, in row order); leaves r at the first
// row not added.
template <int U, typename T, int V, bool MAX, bool PERM>
__device__ __forceinline__ void add_rows(const T* col,
                                         const int64_t* __restrict__ perm,
                                         int64_t& r, int64_t hi, int64_t C,
                                         typename Elt<T>::Acc* acc) {
  using VT = Vec<T, V>;
  for (; r + U <= hi; r += U) {
    VT x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = PERM ? perm[r + u] : r + u;
      x[u] = *reinterpret_cast<const VT*>(col + row * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = step<T, MAX>(acc[v], x[u].v[v]);
  }
}

template <typename T, int V, bool MAX, bool PERM>
__global__ void __launch_bounds__(THREADS)
segment_reduce_kernel(const T* __restrict__ values,
                      const int64_t* __restrict__ perm,
                      const int64_t* __restrict__ offsets,
                      T* __restrict__ out, int64_t n_seg, int64_t cv,
                      int64_t C, int64_t long_rows) {
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_seg * cv) return;
  const int64_t s = t / cv;
  const int64_t c0 = (t - s * cv) * V;
  const int64_t lo = offsets[s], hi = offsets[s + 1];
  if (hi - lo > long_rows) return;             // the block path's segment
  const T* col = values + c0;

  A acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = MAX ? (A)-INFINITY : (A)0;

  int64_t r = lo;
  add_rows<DEEP, T, V, MAX, PERM>(col, perm, r, hi, C, acc);
  add_rows<SHORT, T, V, MAX, PERM>(col, perm, r, hi, C, acc);
  add_rows<1, T, V, MAX, PERM>(col, perm, r, hi, C, acc);

  VT o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = Elt<T>::narrow(acc[v]);
  *reinterpret_cast<VT*>(out + s * C + c0) = o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The block path.  Each block walks the segments s = blockIdx.x,
// blockIdx.x + gridDim.x, ... and sums every one of more than LONG_ROWS
// rows with all its threads: they copy the rows, a stage of `rs` rows at a
// time, into a ring of STAGES shared-memory buffers with 16-byte cp.async
// (STAGES - 1 stages in flight while one is added), and the segment's cv
// owner threads, one per 16-byte column vector, add each stage's rows in
// order.  Same chain, same order as the per-thread path, from shared
// memory instead of registers; a segment too long for one thread's loads
// in flight gets a block's.  Only 16-byte vectors (V * sizeof(T) == 16)
// and rows of at most THREADS vectors take it.
template <typename T, int V, bool MAX, bool PERM>
__global__ void __launch_bounds__(THREADS)
long_segment_kernel(const T* __restrict__ values,
                    const int64_t* __restrict__ perm,
                    const int64_t* __restrict__ offsets,
                    T* __restrict__ out, int64_t n_seg, int cv, int64_t C) {
  static_assert(V * sizeof(T) == 16, "the block path copies 16 bytes");
  extern __shared__ __align__(16) unsigned char smem[];
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  const int tid = threadIdx.x;
  const int rs = STAGE_BYTES / (cv * 16);     // rows a stage holds
  for (int64_t s = blockIdx.x; s < n_seg; s += gridDim.x) {
    const int64_t lo = offsets[s], hi = offsets[s + 1];
    if (hi - lo <= LONG_ROWS) continue;       // uniform over the block
    const int64_t n_st = (hi - lo + rs - 1) / rs;
    auto fetch = [&](int64_t st) {
      if (st < n_st) {
        VT* buf = reinterpret_cast<VT*>(smem + (st % STAGES) * STAGE_BYTES);
        const int64_t r0 = lo + st * rs;
        const int n = (int)(hi - r0 < rs ? hi - r0 : rs) * cv;
        for (int i = tid; i < n; i += THREADS) {
          const int rr = i / cv, c = i - rr * cv;
          const int64_t row = PERM ? perm[r0 + rr] : r0 + rr;
          cp_async16(buf + i, values + row * C + (int64_t)c * V);
        }
      }
      cp_async_commit();          // a group per stage, empty past the end
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) fetch(st);

    A acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = MAX ? (A)-INFINITY : (A)0;
    for (int64_t st = 0; st < n_st; ++st) {
      fetch(st + STAGES - 1);     // into the buffer added last round
      cp_async_wait<STAGES - 1>();
      __syncthreads();            // stage st has landed, every thread's part
      if (tid < cv) {
        const VT* buf = reinterpret_cast<const VT*>(
            smem + (st % STAGES) * STAGE_BYTES);
        const int64_t left = hi - (lo + st * rs);
        const int rows = (int)(left < rs ? left : rs);
#pragma unroll 8
        for (int rr = 0; rr < rows; ++rr) {
          const VT x = buf[rr * cv + tid];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = step<T, MAX>(acc[v], x.v[v]);
        }
      }
      __syncthreads();            // its buffer may be refilled
    }
    if (tid < cv) {
      VT o;
#pragma unroll
      for (int v = 0; v < V; ++v) o.v[v] = Elt<T>::narrow(acc[v]);
      *reinterpret_cast<VT*>(out + s * C + (int64_t)tid * V) = o;
    }
  }
}

// The per-thread path over every segment, then, for 16-byte vectors, the
// block path over the segments it left: two grids on one stream, one call.
template <typename T, int V, bool MAX, bool PERM>
int run(const T* values, const int64_t* perm, const int64_t* offsets, T* out,
        int64_t n_seg, int64_t C, cudaStream_t stream) {
  const int64_t cv = C / V;
  const int64_t blocks = (n_seg * cv + THREADS - 1) / THREADS;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool block_path = V * sizeof(T) == 16 && cv <= THREADS;
  segment_reduce_kernel<T, V, MAX, PERM><<<(unsigned)blocks, THREADS, 0,
                                           stream>>>(
      values, perm, offsets, out, n_seg, cv, C,
      block_path ? LONG_ROWS : INT64_MAX);
  int err = (int)cudaGetLastError();
  if (err || !block_path) return err;
  if constexpr (V * sizeof(T) == 16) {
    auto kernel = long_segment_kernel<T, V, MAX, PERM>;
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LONG_SMEM);
    if (err) return err;
    const unsigned grid = n_seg < LONG_BLOCKS ? (unsigned)n_seg : LONG_BLOCKS;
    kernel<<<grid, THREADS, LONG_SMEM, stream>>>(values, perm, offsets, out,
                                                n_seg, (int)cv, C);
    err = (int)cudaGetLastError();
  }
  return err;
}

template <typename T, int V, bool MAX>
int launch(const void* values, const void* perm, const void* offsets,
           void* out, long long n_seg, long long C, cudaStream_t stream) {
  const T* v = static_cast<const T*>(values);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  T* y = static_cast<T*>(out);
  return perm ? run<T, V, MAX, true>(v, static_cast<const int64_t*>(perm), o,
                                     y, n_seg, C, stream)
              : run<T, V, MAX, false>(v, nullptr, o, y, n_seg, C, stream);
}

template <typename T, bool MAX>
int dispatch(const void* values, const void* perm, const void* offsets,
             void* out, long long n_seg, long long C, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  const bool wide = C % VW == 0 && (uintptr_t)values % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  return wide ? launch<T, VW, MAX>(values, perm, offsets, out, n_seg, C,
                                   stream)
              : launch<T, 1, MAX>(values, perm, offsets, out, n_seg, C,
                                  stream);
}

template <bool MAX>
int by_dtype(int dtype, const void* values, const void* perm,
             const void* offsets, void* out, long long n_seg, long long C,
             cudaStream_t s) {
  switch (dtype) {
    case 0: return dispatch<float, MAX>(values, perm, offsets, out, n_seg, C, s);
    case 1: return dispatch<double, MAX>(values, perm, offsets, out, n_seg, C, s);
    case 2:
      return dispatch<__nv_bfloat16, MAX>(values, perm, offsets, out, n_seg,
                                          C, s);
    case 3: return dispatch<__half, MAX>(values, perm, offsets, out, n_seg, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16.  op: 0 sum, 1 max.
// values (P, C) and out (n_seg, C) contiguous; perm (P,) int64 or null;
// offsets (n_seg + 1,) int64, non-decreasing, offsets[n_seg] <= P.  Returns
// cudaGetLastError() after the launch (0: launched).
extern "C" int segment_reduce(int dtype, int op, const void* values,
                              const void* perm, const void* offsets,
                              void* out, long long n_seg, long long C,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (op == 0) return by_dtype<false>(dtype, values, perm, offsets, out, n_seg, C, s);
  if (op == 1) return by_dtype<true>(dtype, values, perm, offsets, out, n_seg, C, s);
  return (int)cudaErrorInvalidValue;
}
