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
// them (null: the rows are already sorted), the segment of every position
// in that order (`ordered`, non-decreasing) and the (n + 1) offsets of n
// segments in that order, for every segment s and column c:
//
//   sum:  out[s, c] = (((0 + v[r0, c]) + v[r1, c]) + ...)    r0 < r1 < ...
//   max:  out[s, c] = max over the same rows, -inf for an empty segment,
//
// where rk = perm[offsets[s] + k]: a sequential chain of adds in ascending
// row order starting from +0, the order of the plain version (a stable
// sort, then torch.segment_reduce), of index_add_ on the CPU and so of the
// JAX package's segment_sum on its CPU.  Accumulation is the plain
// version's: float32 and float64 add in their own type; bfloat16 and
// float16 widen to float32, add, and round back to nearest even after every
// add (c10's BFloat16 and Half operator+, which segment_reduce applies per
// element).  The max is max(acc, x) = acc < x ? x : acc, a NaN taking over.
//
// Skipping identity rows is exact.  The accumulator starts at +0.0.  Under
// round to nearest, a + b is -0.0 only when both are -0.0, and an exact
// cancellation gives +0.0; the build has no --use_fast_math, so nothing is
// flushed to zero and a subnormal sum stays itself.  So a float32 or
// float64 accumulator is never -0.0, and acc + (+-0.0) == acc bit for bit,
// inf and NaN included.  In bfloat16 and float16 both operands of every add
// are multiples of the format's smallest subnormal, so a non-zero sum never
// rounds to zero: that accumulator is never -0.0 either.  A maximum starts
// at -inf and max(acc, -inf) == acc.  So a row whose values in a chain's
// columns are all +-0 (for a maximum, all -inf; a NaN is never skipped) can
// be left out of the chain at every dtype with the plain version's bits.
// Leaving rows out changes which rows are added, never the order of those
// that are: the chain stays one thread's, in ascending row order.
//
// Bound.  The larger of two times.  Bytes: the kernel must read values
// (P C elt), the permutation (P int64; for sorted rows the searchsorted that
// made the offsets read the index) and the offsets ((n + 1) int64), and
// write the output (n C elt), over 3.35 TB/s on an H100.  The chain floor:
// the longest chain of non-identity rows of one column times the latency
// of one dependent add (about 4 cycles for float32) at the SM clock that
// nvidia-smi reports (1980 MHz).  The main path's long segments are made
// of identity rows (padded edges, masked messages, the clean-up's
// background), so most of its sums are bound by bytes; random values in
// node 0's padded segment of the 1536^2 / 10 000 graph (51 613 rows) are
// bound by the chain floor, 0.104 ms, and so is the clean-up's largest
// foreground component (~475 000 rows of ones, 0.96 ms).
//
// Design.  One launch; its first blocks are the long blocks.
//   Short segments (fewer than `tile` rows, 256 for rows of 256 bytes or
//   more, else 1024; the wrapper picks it): the per-thread path.  One
//   thread owns one segment and a run of V columns (V = 16 bytes of the
//   element type when C is a multiple of V and both base pointers are
//   16-byte aligned, else 1) and adds the segment's rows in order, DEEP
//   (16) rows' loads in flight, then SHORT (4), then one.  Neighbouring
//   threads take neighbouring column runs of one segment, then the next
//   segment's, so a warp reads one row's columns in one coalesced
//   transaction.
//   Long segments (at least `tile` rows): spread over the card.  The rows'
//   positions are cut into tiles of `tile` rows and the columns into groups
//   of GROUP_BYTES (32): a (tile, group) is a unit, and a long block takes
//   UNITS (8) consecutive units of one group, one warp each.  A warp reads
//   the segments of its tile's first and last rows (`ordered`; only these
//   can be long, as a long segment has at least `tile` rows) and, where one
//   is long, reads those segments' rows of the tile in the group's columns
//   (64 rows in flight) and, for a sum, writes the rows that are not
//   identity rows, in ascending order, to its tile's slice of `keep`
//   (int32 row numbers), with their counts for each of the two segments in
//   `count`.  It then
//   adds one to an integer counter per (long segment, group) in `done`,
//   kept at the segment's first tile; the warp that brings it to the
//   segment's number of tiles sets it back to 0 for the next call and has
//   its block walk the segment's chain for the group.  The walk reads the
//   tiles' counts 256 at a time and scans them in shared memory; its loader
//   warps (1-7) look up the kept rows' numbers two chunks ahead and fetch
//   their vectors one chunk ahead (a chunk: 14 KB of the group's vectors,
//   at most 1024 rows), and stage them in shared memory, while the adder
//   threads of warp 0, one per column vector of the group, add the staged
//   chunk in order.
//   A maximum needs no chain.  Its step, acc < x ? x : acc with a NaN
//   taking over, folds a run of rows to the run's last NaN, else the first
//   of its largest values; two consecutive runs join to the same
//   (max_after: the second's NaN, else the first's NaN, else the larger,
//   the first on a tie), so any grouping of the rows in order gives the
//   chain's bits.  So a unit joins each long segment's rows of its tile,
//   32 lanes at a time in row order, into one maximum per column, kept in
//   `keep`'s first bytes, and the walk joins the tiles' maxima in order,
//   32 tiles at a time.  The GAT layer's padded scores are -1e30, not
//   -inf: no row of node 0's segment is an identity row, and the walk
//   still reads one value per tile.
// No float atomics, no block waits on another, no host sync: a call is one
// launch, whatever the data.
// Where the long blocks find no long segment they end at once; 8 units a
// block keep that cost to one check per warp.
// Measured alternatives, kept as profile_port.py --kernels variants: the
// long and the per-thread blocks as two grids on one stream run one after
// the other, and every case pays for the second launch; a walk staged by
// cp.async into two stages took the real values' short walks faster but
// random values' long chains slower (the case the walk is for), so the
// loaders load into registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DEEP = 16;          // rows in flight per thread while 16 remain
constexpr int SHORT = 4;          // ... then while 4 remain
constexpr int MAX_TILE = 1024;    // rows of a tile (its counts take 16 bits)
constexpr int GROUP_BYTES = 32;   // bytes of a row's columns a unit takes
constexpr int UNITS = THREADS / 32;    // (tile, group) units a long block takes
constexpr int LOADERS = THREADS - 32;  // warps 1-7 fetch the kept rows
constexpr int LOADER_BYTES = 64;       // each loader's bytes in flight
constexpr int STAGE_BYTES = LOADERS * LOADER_BYTES;
constexpr int MAX_CHUNK = 1024;        // rows a walk stages at a time
// Bytes of a unit's maxima of one segment: a group's columns in the
// accumulator type, at most twice the element's bytes.
constexpr int MAX_PART = 2 * GROUP_BYTES;

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

// Whether every element of x is a sum's identity, +-0 (a NaN is not).
template <typename T, int V>
__device__ __forceinline__ bool identity(const Vec<T, V>& x) {
  bool id = true;
#pragma unroll
  for (int v = 0; v < V; ++v) id &= Elt<T>::widen(x.v[v]) == 0;
  return id;
}

template <typename T>
struct Args {
  const T* values;
  const int64_t* perm;      // null: rows sorted
  const int64_t* ordered;   // the segment of every position
  const int64_t* offsets;
  T* out;
  int64_t rows, n_seg, C, cv;   // cv: column vectors per row
  int64_t tile, tiles, groups;  // tiles * groups long blocks first
  int64_t long_blocks;
  int32_t* keep;            // (groups, rows) kept row numbers, by tile
  int32_t* count;           // (groups, tiles) kept rows: first | second << 16
  int32_t* done;            // (groups, tiles) tiles finished, by first tile
};

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

// The per-thread path: thread t of the short blocks owns segment t / cv's
// column vector t % cv, unless the segment is long.
template <typename T, int V, bool MAX, bool PERM>
__device__ void short_segment(const Args<T>& a, int64_t t) {
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  if (t >= a.n_seg * a.cv) return;
  const int64_t s = t / a.cv;
  const int64_t c0 = (t - s * a.cv) * V;
  const int64_t lo = a.offsets[s], hi = a.offsets[s + 1];
  if (a.long_blocks && hi - lo >= a.tile) return;   // a long block's
  const T* col = a.values + c0;

  A acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = MAX ? (A)-INFINITY : (A)0;
  int64_t r = lo;
  add_rows<DEEP, T, V, MAX, PERM>(col, a.perm, r, hi, a.C, acc);
  add_rows<SHORT, T, V, MAX, PERM>(col, a.perm, r, hi, a.C, acc);
  add_rows<1, T, V, MAX, PERM>(col, a.perm, r, hi, a.C, acc);

  VT o;
#pragma unroll
  for (int v = 0; v < V; ++v) o.v[v] = Elt<T>::narrow(acc[v]);
  *reinterpret_cast<VT*>(a.out + s * a.C + c0) = o;
}

__device__ __forceinline__ int64_t clamp_seg(int64_t s, int64_t n_seg) {
  return s < 0 ? 0 : (s >= n_seg ? n_seg - 1 : s);
}

// Exclusive prefix sum of x over the block; `warps` holds THREADS / 32
// ints.  Returns the sum before this thread; *total the block's sum.
__device__ __forceinline__ int block_scan(int x, int* warps, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warps[w] = inc;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    before += i < w ? warps[i] : 0;
    sum += warps[i];
  }
  __syncthreads();                  // warps may be reused
  *total = sum;
  return before + inc - x;
}

// A barrier of the loader warps (1-7) alone.
__device__ __forceinline__ void loaders_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(LOADERS) : "memory");
}

// Two maxima of consecutive runs of rows, a's run first, as the chain over
// both runs gives it: the last NaN, else the first of the largest.
template <typename A>
__device__ __forceinline__ A max_after(A a, A b) {
  return isnan(b) ? b : (isnan(a) ? a : (a < b ? b : a));
}

// The maximum of the lanes' values in lane order, in lane 0.
template <typename A>
__device__ __forceinline__ A warp_max(A x) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const A right = __shfl_down_sync(0xffffffffu, x, d);
    if ((threadIdx.x & (2 * d - 1)) == 0) x = max_after(x, right);
  }
  return x;
}

// Where a maximum's unit (group g, tile t) keeps part i's maxima: MAX_PART
// bytes each from the start of keep, which a maximum uses for nothing else
// (keep holds 4 bytes a row and group, a tile at least 256 rows: more
// than the 4 GROUP_BYTES of a tile's two parts).
template <typename T>
__device__ __forceinline__ typename Elt<T>::Acc* max_part(const Args<T>& a,
                                                          int64_t g,
                                                          int64_t t, int i) {
  using A = typename Elt<T>::Acc;
  return reinterpret_cast<A*>(reinterpret_cast<char*>(a.keep) +
                              ((g * a.tiles + t) * 2 + i) * MAX_PART);
}

// One (tile, group) of the long blocks and the long segments of its rows.
struct Unit {
  int64_t t, s[2], lo[2], hi[2];
  int g;
  bool is_long[2];
};

// Shared memory of a long block.
template <typename T, int V>
struct LongSmem {
  Unit unit[UNITS];
  int64_t walk[2 * UNITS];          // segments this block walks ...
  int walk_g[2 * UNITS];            // ... and their groups
  int n_walks;
  int warps[THREADS / 32];
  int pre[THREADS + 1];             // scanned kept counts of a tile batch
  int begin[THREADS];               // each tile's first entry for the segment
  int row[2][MAX_CHUNK];            // two chunks' row numbers
  Vec<T, V> stage[STAGE_BYTES / (V * sizeof(T))];
};

// A maximum of long segment s for group g's column vectors: its tiles'
// maxima joined in order, 32 tiles at a time, by warp 0.
template <typename T, int V>
__device__ void walk_max(const Args<T>& a, int64_t s, int g) {
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  constexpr int GV = GROUP_BYTES / (V * sizeof(T));
  static_assert(GV * V * sizeof(A) <= MAX_PART, "a unit's maxima fit");
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  const int64_t gc0 = (int64_t)g * GV;
  const int nvec = (int)(a.cv - gc0 < GV ? a.cv - gc0 : GV);
  const int64_t lo = a.offsets[s], hi = a.offsets[s + 1];
  const int64_t t0 = lo / a.tile, t1 = (hi - 1) / a.tile;
  A acc[GV][V];
#pragma unroll
  for (int v = 0; v < GV; ++v)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[v][e] = (A)-INFINITY;
  for (int64_t tb = t0; tb <= t1; tb += 32) {
    const int64_t t = tb + tid;
    // In its first tile the segment may be the tile's second one.
    const A* src = t <= t1 ? max_part(a, g, t, t == t0 && lo != t0 * a.tile)
                           : nullptr;
#pragma unroll
    for (int v = 0; v < GV; ++v) {
      if (v >= nvec) continue;                      // uniform
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc[v][e] = max_after(acc[v][e], warp_max(
            src ? __ldcg(src + v * V + e) : (A)-INFINITY));
    }
  }
  if (tid == 0)
#pragma unroll
    for (int v = 0; v < GV; ++v) {
      if (v >= nvec) continue;
      VT o;
#pragma unroll
      for (int e = 0; e < V; ++e) o.v[e] = Elt<T>::narrow(acc[v][e]);
      *reinterpret_cast<VT*>(a.out + s * a.C + (gc0 + v) * V) = o;
    }
}

// Walks long segment s for group g's column vectors: the kept rows of its
// tiles, in order.  Every thread of the block calls it.
template <typename T, int V, bool MAX, bool PERM>
__device__ void walk_segment(const Args<T>& a, LongSmem<T, V>& sm, int64_t s,
                             int g) {
  if constexpr (MAX) {
    walk_max<T, V>(a, s, g);
    return;
  }
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  constexpr int GV = GROUP_BYTES / (V * sizeof(T));
  constexpr int STAGE_VECS = STAGE_BYTES / (V * sizeof(T));
  constexpr int PER_LOADER = STAGE_VECS / LOADERS;
  const int tid = threadIdx.x;
  const int li = tid - 32;                 // loader index, < 0 in warp 0
  const int64_t gc0 = (int64_t)g * GV;
  const int nvec = (int)(a.cv - gc0 < GV ? a.cv - gc0 : GV);
  // Rows staged at a time: the stage holds STAGE_VECS of the group's
  // vectors.
  const int chunk = STAGE_VECS / nvec < MAX_CHUNK ? STAGE_VECS / nvec
                                                  : MAX_CHUNK;
  const int64_t lo = a.offsets[s], hi = a.offsets[s + 1];
  const int64_t t0 = lo / a.tile, t1 = (hi - 1) / a.tile;
  const int32_t* keep = a.keep + g * a.rows;
  const T* base = a.values + gc0 * V;

  A acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = MAX ? (A)-INFINITY : (A)0;

  for (int64_t tb = t0; tb <= t1; tb += THREADS) {
    const int64_t t = tb + tid;
    int n = 0, first = 0;
    if (t <= t1) {
      const int packed = __ldcg(a.count + g * a.tiles + t);
      const int c0 = packed & 0xffff, c1 = packed >> 16;
      // In its first tile the segment may be the tile's second one.
      if (t == t0 && lo != t0 * a.tile) {
        first = c0;
        n = c1;
      } else {
        n = c0;
      }
    }
    int K;
    const int before = block_scan(n, sm.warps, &K);
    sm.pre[tid] = before;
    sm.begin[tid] = first;
    if (tid == 0) sm.pre[THREADS] = K;
    const int nt = (int)(t1 - tb + 1 < THREADS ? t1 - tb + 1 : THREADS);
    __syncthreads();

    // The loaders' work for a chunk, two steps apart: the row numbers of
    // entries k0, k0 + 1, ... (entry k from the tile q with pre[q] <= k <
    // pre[q + 1]) into a row buffer; later, the vectors of those rows,
    // vector e being row e / nvec's vector e % nvec.  While the adders add
    // chunk c, chunk c + 1's vectors are in flight and chunk c + 2's row
    // numbers are looked up.
    constexpr int RJ = (MAX_CHUNK + LOADERS - 1) / LOADERS;
    int q = 0;                      // this loader's last tile, a hint
    auto rows_of = [&](int k0, int* buf) {
      const int32_t* src[RJ];
#pragma unroll
      for (int i = 0; i < RJ; ++i) {
        const int j = li + i * LOADERS, k = k0 + j;
        src[i] = nullptr;
        if (j < chunk && k < K) {
          if (sm.pre[q + 1] <= k) {   // not the hint's tile: search on
            int q1 = nt;              // pre[q] <= k < pre[q1]
            q = q + 1;
            while (q1 - q > 1) {
              const int m = (q + q1) >> 1;
              if (sm.pre[m] <= k) q = m; else q1 = m;
            }
          }
          src[i] = keep + (tb + q) * a.tile + sm.begin[q] + (k - sm.pre[q]);
        }
      }
      int got[RJ];                  // every load in flight, then stored
#pragma unroll
      for (int i = 0; i < RJ; ++i)
        if (src[i]) got[i] = __ldcg(src[i]);
#pragma unroll
      for (int i = 0; i < RJ; ++i)
        if (src[i]) buf[li + i * LOADERS] = got[i];
    };
    VT x[PER_LOADER];
    auto vectors_of = [&](int k0, const int* buf) {
#pragma unroll
      for (int i = 0; i < PER_LOADER; ++i) {
        const int e = li + i * LOADERS, j = e / nvec;
        if (j < chunk && k0 + j < K)
          x[i] = reinterpret_cast<const VT*>(
              base + (int64_t)buf[j] * a.C)[e - j * nvec];
      }
    };
    if (li >= 0 && K > 0) {
      rows_of(0, sm.row[0]);
      if (chunk < K) rows_of(chunk, sm.row[1]);
      loaders_sync();
      vectors_of(0, sm.row[0]);
    }
    // Chunk c is staged and added while the loaders' vectors of chunk c + 1
    // are in flight and chunk c + 2's row numbers are looked up.
    for (int k0 = 0, c = 0; k0 < K; k0 += chunk, ++c) {
#pragma unroll
      for (int i = 0; i < PER_LOADER; ++i) {
        const int e = li + i * LOADERS, j = e / nvec;
        if (li >= 0 && j < chunk && k0 + j < K) sm.stage[e] = x[i];
      }
      __syncthreads();              // chunk c is staged
      if (li >= 0) {
        if (k0 + chunk < K) vectors_of(k0 + chunk, sm.row[(c + 1) & 1]);
        if (k0 + 2 * chunk < K) rows_of(k0 + 2 * chunk, sm.row[c & 1]);
        loaders_sync();             // the row buffers' readers are done
      }
      const int rows = K - k0 < chunk ? K - k0 : chunk;
      const VT* st = sm.stage;
      if (tid < nvec) {
        // The chain, U rows at a time: the next U rows' loads are in
        // flight while these are added.
        constexpr int U = V >= 4 ? 4 : 16 / V;
        auto load = [&](VT* y, int b) {
#pragma unroll
          for (int u = 0; u < U; ++u) y[u] = st[(b * U + u) * nvec + tid];
        };
        auto add = [&](const VT* y) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = step<T, MAX>(acc[v], y[u].v[v]);
        };
        const int full = rows / U;
        VT y[U], z[U];
        if (full > 0) load(y, 0);
        int b = 0;
        for (; b + 2 <= full; b += 2) {    // y holds batch b
          load(z, b + 1);
          add(y);
          if (b + 2 < full) load(y, b + 2);
          add(z);
        }
        if (b < full) add(y);
        for (int j = full * U; j < rows; ++j) {
          const VT y1 = st[j * nvec + tid];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = step<T, MAX>(acc[v], y1.v[v]);
        }
      }
      __syncthreads();              // the stage may be refilled
    }
  }
  if (tid < nvec) {
    VT o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = Elt<T>::narrow(acc[v]);
    *reinterpret_cast<VT*>(a.out + s * a.C + (gc0 + tid) * V) = o;
  }
}

// Compacts one unit with one warp: writes its rows of long segments that
// are not identity rows, in ascending position order (the first
// segment's, then the second's), to its slice of keep, and their counts
// to count; then adds one to each long segment's counter, and lists the
// segments whose last unit this was among the block's walks.
template <typename T, int V, bool MAX, bool PERM>
__device__ void compact_unit(const Args<T>& a, LongSmem<T, V>& sm,
                             const Unit& u) {
  using A = typename Elt<T>::Acc;
  using VT = Vec<T, V>;
  constexpr int GV = GROUP_BYTES / (V * sizeof(T));
  constexpr int R = 2;                  // rounds of 32 rows in flight
  const int lane = threadIdx.x & 31;
  const int64_t p0 = u.t * a.tile;
  const int64_t pe = p0 + a.tile < a.rows ? p0 + a.tile : a.rows;
  // The long segments' positions in the tile: [p0, e0) and [b1, pe).
  const int64_t e0 = u.is_long[0] ? (u.hi[0] < pe ? u.hi[0] : pe) : p0;
  const int64_t b1 = u.is_long[1] ? u.lo[1] : pe;
  const int64_t gc0 = (int64_t)u.g * GV;
  const int nvec = (int)(a.cv - gc0 < GV ? a.cv - gc0 : GV);
  const unsigned below = (1u << lane) - 1;

  int32_t* keep = a.keep + u.g * a.rows + p0;
  int kept = 0, kept0 = 0;
  A part[2][GV][V];                     // a maximum's parts, in lane 0
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int v = 0; v < GV; ++v)
#pragma unroll
      for (int e = 0; e < V; ++e) part[i][v][e] = (A)-INFINITY;
  for (int r0 = 0; r0 < pe - p0; r0 += R * 32) {   // uniform over the warp
    int row[R];
    bool in[R];
    VT x[R][GV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t p = p0 + r0 + r * 32 + lane;
      in[r] = p < e0 || (p >= b1 && p < pe);
      row[r] = in[r] ? (int)(PERM ? a.perm[p] : p) : 0;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (in[r]) {
        const VT* src = reinterpret_cast<const VT*>(
            a.values + (int64_t)row[r] * a.C + gc0 * V);
#pragma unroll
        for (int v = 0; v < GV; ++v)
          if (v < nvec) x[r][v] = src[v];
      }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool first = p0 + r0 + r * 32 + lane < e0;
      if (MAX) {
        // Each part's rows of the round joined in lane (row) order into
        // lane 0, then after the part's earlier rounds.
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (!u.is_long[i]) continue;                // uniform
          const bool mine = in[r] && first == (i == 0);
#pragma unroll
          for (int v = 0; v < GV; ++v) {
            if (v >= nvec) continue;                  // uniform
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const A y = warp_max(mine ? Elt<T>::widen(x[r][v].v[e])
                                        : (A)-INFINITY);
              part[i][v][e] = max_after(part[i][v][e], y);
            }
          }
        }
        continue;
      }
      bool k = in[r];
      if (k) {
        bool id = true;
#pragma unroll
        for (int v = 0; v < GV; ++v)
          if (v < nvec) id &= identity<T, V>(x[r][v]);
        k = !id;
      }
      const unsigned m = __ballot_sync(0xffffffffu, k);
      if (k) keep[kept + __popc(m & below)] = row[r];
      kept += __popc(m);
      kept0 += __popc(__ballot_sync(0xffffffffu, k && first));
    }
  }
  if (MAX && lane == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (u.is_long[i]) {
        A* dst = max_part(a, u.g, u.t, i);
#pragma unroll
        for (int v = 0; v < GV; ++v)
#pragma unroll
          for (int e = 0; e < V; ++e) dst[v * V + e] = part[i][v][e];
      }

  // Hand-off: the unit that finishes a long segment's last tile of the
  // group has its block walk it.
  if (lane == 0) a.count[u.g * a.tiles + u.t] = kept0 | ((kept - kept0) << 16);
  __threadfence();
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!u.is_long[i]) continue;
      const int64_t first = u.lo[i] / a.tile, last = (u.hi[i] - 1) / a.tile;
      int32_t* d = a.done + u.g * a.tiles + first;
      if (atomicAdd(d, 1) == (int)(last - first)) {
        __threadfence();
        atomicExch(d, 0);                      // zero for the next call
        const int w = atomicAdd(&sm.n_walks, 1);
        sm.walk[w] = u.s[i];
        sm.walk_g[w] = u.g;
      }
    }
  }
}

// A long block: UNITS units (tile, group), group-major, one checked and
// compacted by each warp where it holds rows of a long segment; then the
// block walks the segments its warps finished.
template <typename T, int V, bool MAX, bool PERM>
__device__ void long_block(const Args<T>& a, int64_t b) {
  __shared__ LongSmem<T, V> sm;
  const int tid = threadIdx.x, w = tid >> 5;
  if (tid % 32 == 0) {
    const int64_t id = b * UNITS + w;
    Unit u{};
    if (id < a.tiles * a.groups) {
      u.g = (int)(id / a.tiles);
      u.t = id - u.g * a.tiles;
      const int64_t p0 = u.t * a.tile;
      const int64_t pe = p0 + a.tile < a.rows ? p0 + a.tile : a.rows;
      // The segments of the tile's first and last rows (clamped: a row
      // outside [offsets[0], offsets[n_seg]) belongs to no segment).
      u.s[0] = clamp_seg(a.ordered[p0], a.n_seg);
      u.s[1] = clamp_seg(a.ordered[pe - 1], a.n_seg);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        u.lo[i] = a.offsets[u.s[i]];
        u.hi[i] = a.offsets[u.s[i] + 1];
      }
      u.is_long[0] = u.lo[0] <= p0 && p0 < u.hi[0] &&
                     u.hi[0] - u.lo[0] >= a.tile;
      u.is_long[1] = u.s[1] != u.s[0] && u.lo[1] < pe && pe <= u.hi[1] &&
                     u.hi[1] - u.lo[1] >= a.tile;
    }
    sm.unit[w] = u;
  }
  if (tid == 0) sm.n_walks = 0;
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int i = 0; i < UNITS; ++i)
    any |= sm.unit[i].is_long[0] || sm.unit[i].is_long[1];
  if (!any) return;                            // uniform over the block
  if (sm.unit[w].is_long[0] || sm.unit[w].is_long[1])   // uniform per warp
    compact_unit<T, V, MAX, PERM>(a, sm, sm.unit[w]);
  __syncthreads();
  for (int i = 0; i < sm.n_walks; ++i)
    walk_segment<T, V, MAX, PERM>(a, sm, sm.walk[i], sm.walk_g[i]);
}

template <typename T, int V, bool MAX, bool PERM>
__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(Args<T> a) {
  const int64_t b = blockIdx.x;
  if (b < a.long_blocks) {
    long_block<T, V, MAX, PERM>(a, b);
  } else {
    short_segment<T, V, MAX, PERM>(a, (b - a.long_blocks) * THREADS +
                                          threadIdx.x);
  }
}

template <typename T, int V, bool MAX>
int launch(Args<T> a, cudaStream_t stream) {
  constexpr int GV = GROUP_BYTES / (V * sizeof(T));
  a.cv = a.C / V;
  a.groups = (a.cv + GV - 1) / GV;
  a.tiles = (a.rows + a.tile - 1) / a.tile;
  a.long_blocks =
      a.rows >= a.tile ? (a.tiles * a.groups + UNITS - 1) / UNITS : 0;
  const int64_t blocks =
      a.long_blocks + (a.n_seg * a.cv + THREADS - 1) / THREADS;
  if (a.n_seg * a.cv == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (a.perm)
    segment_reduce_kernel<T, V, MAX, true><<<(unsigned)blocks, THREADS, 0,
                                             stream>>>(a);
  else
    segment_reduce_kernel<T, V, MAX, false><<<(unsigned)blocks, THREADS, 0,
                                              stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool MAX>
int dispatch(int vec, Args<T> a, cudaStream_t stream) {
  constexpr int VW = 16 / sizeof(T);
  if (vec == 1) return launch<T, 1, MAX>(a, stream);
  if (vec == VW && a.C % VW == 0 && (uintptr_t)a.values % 16 == 0 &&
      (uintptr_t)a.out % 16 == 0)
    return launch<T, VW, MAX>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_op(int op, int vec, Args<T> a, cudaStream_t stream) {
  if (op == 0) return dispatch<T, false>(vec, a, stream);
  if (op == 1) return dispatch<T, true>(vec, a, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
Args<T> args(const void* values, const void* perm, const void* ordered,
             const void* offsets, void* out, long long rows, long long n_seg,
             long long C, long long tile, void* keep, void* count,
             void* done) {
  Args<T> a{};
  a.values = static_cast<const T*>(values);
  a.perm = static_cast<const int64_t*>(perm);
  a.ordered = static_cast<const int64_t*>(ordered);
  a.offsets = static_cast<const int64_t*>(offsets);
  a.out = static_cast<T*>(out);
  a.rows = rows;
  a.n_seg = n_seg;
  a.C = C;
  a.tile = tile;
  a.keep = static_cast<int32_t*>(keep);
  a.count = static_cast<int32_t*>(count);
  a.done = static_cast<int32_t*>(done);
  return a;
}

}  // namespace

// dtype: 0 float32, 1 float64, 2 bfloat16, 3 float16.  op: 0 sum, 1 max.
// vec: 1, or 16 / element bytes (C a multiple of it, values and out 16-byte
// aligned).  values (rows, C) and out (n_seg, C) contiguous; perm (rows,)
// int64 or null; ordered (rows,) int64, the segment of each position in
// perm's order; offsets (n_seg + 1,) int64, non-decreasing, offsets[n_seg]
// <= rows (the rows outside [offsets[0], offsets[n_seg]) are in no
// segment).  tile: a multiple of 256, at most 1024.  With rows >= tile:
// keep (groups * rows) int32, count (groups * tiles) int32 and done
// (groups * tiles) int32, done all 0 (the kernel leaves it so), where
// tiles = ceil(rows / tile) and groups = ceil(C / vec / (32 / (vec * element
// bytes))).  rows < 2^31.  Returns cudaGetLastError() after the launch (0:
// launched).
extern "C" int segment_reduce(int dtype, int op, int vec, long long tile,
                              const void* values, const void* perm,
                              const void* ordered, const void* offsets,
                              void* out, long long rows, long long n_seg,
                              long long C, void* keep, void* count,
                              void* done, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (tile <= 0 || tile > MAX_TILE || tile % THREADS || rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return by_op<float>(op, vec, args<float>(values, perm, ordered, offsets,
                                               out, rows, n_seg, C, tile, keep,
                                               count, done), s);
    case 1:
      return by_op<double>(op, vec, args<double>(values, perm, ordered,
                                                 offsets, out, rows, n_seg, C,
                                                 tile, keep, count, done), s);
    case 2:
      return by_op<__nv_bfloat16>(
          op, vec, args<__nv_bfloat16>(values, perm, ordered, offsets, out,
                                       rows, n_seg, C, tile, keep, count,
                                       done), s);
    case 3:
      return by_op<__half>(op, vec, args<__half>(values, perm, ordered,
                                                 offsets, out, rows, n_seg, C,
                                                 tile, keep, count, done), s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
