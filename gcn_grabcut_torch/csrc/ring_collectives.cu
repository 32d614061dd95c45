// Direct all-gather (K2) and direct reduce-scatter (K3) for Hopper (sm_90a):
// the halo exchange of the graph-sharded 10k-node aggregation and its
// gradient, each one shot: no hops between ranks.
//
// Replaces the TPU kernels of gcn_grabcut_tpu/parallel/ring_pallas.py:
//   K2  _all_gather_impl (body _ring_kernel): rank r holds one (chunk, D)
//       block and ends with all n blocks of the ring, concatenated;
//   K3  _reduce_scatter_impl (body _reduce_scatter_kernel): rank r holds a
//       (n chunk, D) cotangent g_r and ends with sum_j g_j[block r], summed
//       in the ring's order.  K3 is K2's gradient and K2 is K3's.
//
// Launch.  One cooperative launch per collective call, grid (B, n):
// blockIdx.y is the rank and blockIdx.x one of the B thread blocks of a
// rank.  Block b of every rank owns the same slice of the chunk (16-byte
// vectors [b per, (b + 1) per)), so it waits only on block b of other ranks:
// one signal word per (rank, phase, block) and no grid-wide barrier.  A
// cooperative launch makes every block resident at once or fails, so blocks
// that spin on each other cannot deadlock because one of them was never
// scheduled.  The kernels reach every rank's buffers only through the
// pointer table in their arguments: all ranks live on one card here, and a
// later launcher can fill the table with peer pointers.
//
// K2, one shot, push.  Block b of rank r reads slice b of its own block once
// and writes it to slot r of every rank's output, its own included:
//   out_j[r][slice b] = in_r[slice b]                      for j = 0 .. n-1.
// Every byte of out is written exactly once per call and none is read back,
// so there are no comm slots to reuse: the Pallas kernel double-buffers
// through two and needs ack credits, and ADVICE.md records the race of an
// ack sent before the slot's outgoing copy had read it.  Each thread loads
// up to U = 8 vectors of the slice with ld.global.cg, all in flight at once,
// and stores each of them n times with st.global.cg; at the sharded path's
// shapes a block's slice (~1 200 vectors) is one such batch.  Stores to a
// peer over NVLink are posted writes, where loads are round trips, so a push
// suits peer memory; it also makes K2 the mirror image of K3, which has to
// pull because it sums.  The ring that K2 used to be ran n - 1 hops in
// series, each a signal round trip with a short copy between, and read back
// what the previous hop had written.
//   The copy through the TMA unit (one thread per block, 1-D cp.async.bulk
// loads of 8 KB pieces into a ring of 4 shared-memory buffers counted on
// mbarriers, n bulk stores per piece) was built and measured first: it is
// right, but ~2 us slower a call than this vector copy at n = 2, 4 and 8 on
// an H100 (PERF.md).  profile_port.py keeps it as a variant.
//
// K3, one shot.  Block b of rank r reads slice b of block r straight from
// every rank's g_j and writes the sum into out_r:
//   acc = g_{r+1}[r];  acc = g_{r+k}[r] + acc for k = 2 .. n-1;
//   out_r = g_r[r] + acc                                  (indices mod n)
// in the input dtype (float32 adds; bf16 widened, added in float32 and
// rounded to nearest even at every add): the order and rounding of the
// plain version in parallel/ring.py and of the Pallas ring, so the result
// is the ring's bit for bit.  Each thread issues the n loads of U vectors
// (U n <= 16) before it adds any of them.  The ring was dropped because its
// n - 1 hops ran in series, each a signal round trip with little work
// between, and because the partial sums went through receive slots that
// were written and read again: n (3n - 1) E bytes moved against the bound's
// (n^2 + n) E.
//
// Why one shot on Hopper.  Across NVLink each rank sends (K2) or fetches
// (K3) (n - 1) E bytes to or from its peers, as many as a ring sends, so the
// link bound is the same; the H100's NVSwitch joins every pair of cards at
// full rate, where the TPU's torus links only neighbours, which is what made
// the ring the TPU's schedule.
//
// Handshakes.  Two per call, on words (rank, phase, block): rank r's row 0
// word says "block b has entered this call", row 1 "block b is done with
// the peers' buffers".
//   entry: block b of rank r stores the epoch, relaxed, into (r, 0, b);
//          nothing of this call precedes it (rank r's buffers were finished
//          by earlier work on its stream).  It touches rank j's buffers (K2
//          writes out_j, K3 reads g_j) only once word (j, 0, b) carries the
//          epoch: rank j's kernel has started, so its buffers are live.
//   exit:  block b of rank r releases (r, 1, b) once its accesses to the
//          peers are complete, and returns only once every (j, 1, b)
//          carries the epoch: for K2, every peer's slice b has landed in
//          out_r; for K3, no peer still reads g_r.
// A release is a barrier, then one st.release.sys by thread 0: the barrier
// orders the block's accesses (K2's stores, K3's loads) before it and a
// system-scope release is cumulative over them, so no fence.sc.sys is
// needed (~4 us a call on an H100).  A peer whose ld.acquire.sys reads the
// epoch therefore sees K2's data.  That holds because K2's stores are
// generic-proxy stores.  The TMA variant's bulk stores run in the async
// proxy, which the release does not cover by itself: its issuing thread
// must first wait with cp.async.bulk.wait_group 0 (the stores complete, not
// merely read out of shared memory) and then fence.proxy.async.global, and
// fence the same way after the entry wait, before its first bulk store.  A
// waiting thread spins on ld.acquire.sys with __nanosleep back-off until
// the word reaches the epoch, then the block synchronises; n - 1 threads
// spin on the n - 1 peers at once.  Every spin is bounded and ends in
// __trap(): a protocol fault fails the run instead of hanging it.  Epochs
// rise with every call on a mesh, so the words are never reset and a word
// left by an earlier call never satisfies a wait; calls on one mesh must
// therefore be ordered on one stream.  System scope keeps the code right
// for peer memory.  Data written by other kernels is read with
// ld.global.cg, so no stale L1 line of an earlier call is seen.
//
// Bound.  With E = chunk * D * elt bytes per block, K2 must read at least
// n E and write n^2 E; K3 must read at least n^2 E and write n E (its n^2
// chunk D adds are far below the card's rate).  On one H100 that is
// (n + n^2) E / 3.35 TB/s for either, and both move exactly that.  Across
// NVLink each rank sends or fetches (n - 1) E over one 450 GB/s direction:
// (n - 1) E / 450 GB/s, the same as the ring's.
//
// Optional stress aid: a table of nanosecond delays, null on the path, that
// stalls a rank's blocks to provoke races under timing skew.  Both kernels
// read it as (rank, phase): column 0 before the entry signal, column 1
// after the copies or reads, before the exit signal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;
constexpr long long MAX_SPINS = 1LL << 22;   // ~4 s at the 1 us back-off cap

struct RingTable {
  const int4* in[MAX_RANKS];            // K2: block; K3: g (n chunk rows)
  int4* out[MAX_RANKS];                 // K2: n chunk rows; K3: chunk rows
  unsigned long long* sig[MAX_RANKS];   // (2, sig_stride) words
  int delay_ns[MAX_RANKS][MAX_RANKS];   // (rank, phase)
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Every thread's accesses so far, then the word.  The barrier orders the
// block's accesses before thread 0's release, and a release at system scope
// is cumulative over them: no separate fence.sc.sys is needed.
__device__ __forceinline__ void release_word(unsigned long long* word,
                                             unsigned long long epoch) {
  __syncthreads();
  if (threadIdx.x == 0) st_release_sys(word, epoch);
}

// Spin, bounded, until the word carries this call's epoch.
__device__ __forceinline__ void spin_until(const unsigned long long* word,
                                           unsigned long long epoch) {
  unsigned ns = 32;
  long long spins = 0;
  while (ld_acquire_sys(word) < epoch) {
    if (++spins > MAX_SPINS) __trap();
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
  }
}

__device__ __forceinline__ void stall(int ns) {
  if (ns > 0) {
    if (threadIdx.x == 0) __nanosleep((unsigned)ns);
    __syncthreads();
  }
}

struct AddF32 {
  static __device__ __forceinline__ int4 add(int4 a, int4 b) {
    int4 r;
    r.x = __float_as_int(__fadd_rn(__int_as_float(a.x), __int_as_float(b.x)));
    r.y = __float_as_int(__fadd_rn(__int_as_float(a.y), __int_as_float(b.y)));
    r.z = __float_as_int(__fadd_rn(__int_as_float(a.z), __int_as_float(b.z)));
    r.w = __float_as_int(__fadd_rn(__int_as_float(a.w), __int_as_float(b.w)));
    return r;
  }
};

struct AddBF16 {
  static __device__ __forceinline__ int add2(int a, int b) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
    const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
    __nv_bfloat162 s =
        __floats2bfloat162_rn(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y));
    return *reinterpret_cast<int*>(&s);
  }
  static __device__ __forceinline__ int4 add(int4 a, int4 b) {
    return make_int4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                     add2(a.w, b.w));
  }
};

// Until word `off` of every rank but r carries the epoch, thread j waiting
// on rank j; then the whole block goes on.
__device__ __forceinline__ void wait_peers(const RingTable& t, int n, int r,
                                           long long off,
                                           unsigned long long epoch) {
  const int j = threadIdx.x;
  if (j < n && j != r) spin_until(t.sig[j] + off, epoch);
  __syncthreads();
}

// K2.  vecs = 16-byte vectors per chunk; the signal word of (rank r, phase
// k, block b) is sig[r][k * sig_stride + b].  Each thread loads up to U
// vectors of its rank's slice, all in flight at once, then stores each of
// them to every rank.
__global__ void __launch_bounds__(THREADS)
direct_all_gather_kernel(RingTable t, int n, long long vecs, int sig_stride,
                         unsigned long long epoch) {
  constexpr int U = 8;   // vectors a thread keeps in flight
  const int r = blockIdx.y;
  const int b = blockIdx.x;
  const long long per = (vecs + gridDim.x - 1) / gridDim.x;
  const long long v0 = min(vecs, b * per);
  const long long v1 = min(vecs, v0 + per);

  // Entry: as K3's.
  stall(t.delay_ns[r][0]);
  if (threadIdx.x == 0) st_relaxed_sys(t.sig[r] + b, epoch);
  wait_peers(t, n, r, b, epoch);

  const int4* in = t.in[r];
  const long long own = (long long)r * vecs;
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)U * THREADS) {
    int4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long w = v + (long long)u * THREADS;
      if (w < v1) x[u] = __ldcg(in + w);
    }
    for (int j = 0; j < n; ++j) {
      int4* out = t.out[j] + own;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long w = v + (long long)u * THREADS;
        if (w < v1) __stcg(out + w, x[u]);
      }
    }
  }

  // Exit: the release orders every store into the peers' outputs before
  // the word; a rank returns once every peer's slice b is in its output.
  stall(t.delay_ns[r][1]);
  release_word(t.sig[r] + sig_stride + b, epoch);
  wait_peers(t, n, r, (long long)sig_stride + b, epoch);
}

// K3 for n <= NMAX ranks, with Op::add the input dtype's elementwise sum of
// two vectors.  Block b of rank r signals word (r, 0, b) on entry and (r, 1,
// b) once its reads are done.
template <int NMAX, class Op>
__global__ void __launch_bounds__(THREADS)
direct_reduce_scatter_kernel(RingTable t, int n, long long vecs,
                             int sig_stride, unsigned long long epoch) {
  constexpr int U = NMAX <= 4 ? 4 : 16 / NMAX;   // vectors per batch
  const int r = blockIdx.y;
  const int b = blockIdx.x;
  const long long per = (vecs + gridDim.x - 1) / gridDim.x;
  const long long v0 = min(vecs, b * per);
  const long long v1 = min(vecs, v0 + per);

  // Entry: nothing of this call precedes the word, so it is a relaxed
  // store; rank r's g was finished by earlier work on its stream.
  stall(t.delay_ns[r][0]);
  if (threadIdx.x == 0) st_relaxed_sys(t.sig[r] + b, epoch);
  wait_peers(t, n, r, b, epoch);

  // src[k]: block r of g_{r+k}; the sum's order is fixed by k.
  const int4* src[NMAX];
#pragma unroll
  for (int k = 0; k < NMAX; ++k)
    src[k] = k < n ? t.in[(r + k) % n] + (long long)r * vecs : nullptr;
  int4* out = t.out[r];
  for (long long v = v0 + threadIdx.x; v < v1; v += (long long)U * THREADS) {
    int4 x[U][NMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long w = v + (long long)u * THREADS;
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n && w < v1) x[u][k] = __ldcg(src[k] + w);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long w = v + (long long)u * THREADS;
      if (w < v1) {
        int4 acc = x[u][1];
#pragma unroll
        for (int k = 2; k < NMAX; ++k)
          if (k < n) acc = Op::add(x[u][k], acc);
        __stcg(out + w, Op::add(x[u][0], acc));
      }
    }
  }

  // Exit: the release orders every read of the peers' g before the word.
  stall(t.delay_ns[r][1]);
  release_word(t.sig[r] + sig_stride + b, epoch);
  wait_peers(t, n, r, (long long)sig_stride + b, epoch);
}

using Kernel = void (*)(RingTable, int, long long, int, unsigned long long);

template <class Op>
Kernel reduce_scatter_for(int n) {
  if (n <= 2) return direct_reduce_scatter_kernel<2, Op>;
  if (n <= 4) return direct_reduce_scatter_kernel<4, Op>;
  if (n <= 8) return direct_reduce_scatter_kernel<8, Op>;
  return direct_reduce_scatter_kernel<16, Op>;
}

int fill(RingTable& t, const void* const* in, void* const* out,
         void* const* sig, int n, const int* delay_ns) {
  if (n < 2 || n > MAX_RANKS) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < MAX_RANKS; ++r) {
    const bool on = r < n;
    t.in[r] = on ? static_cast<const int4*>(in[r]) : nullptr;
    t.out[r] = on ? static_cast<int4*>(out[r]) : nullptr;
    t.sig[r] = on ? static_cast<unsigned long long*>(sig[r]) : nullptr;
    for (int s = 0; s < MAX_RANKS; ++s)
      t.delay_ns[r][s] = on && s < n && delay_ns ? delay_ns[r * n + s] : 0;
  }
  return 0;
}

int launch(Kernel kernel, const void* const* in, void* const* out,
           void* const* sig, int n, long long chunk_bytes, int sig_blocks,
           unsigned long long epoch, const int* delay_ns, void* stream) {
  RingTable t;
  cudaError_t err = (cudaError_t)fill(t, in, out, sig, n, delay_ns);
  if (err != cudaSuccess) return (int)err;
  if (chunk_bytes <= 0 || chunk_bytes % 16 || sig_blocks < 1)
    return (int)cudaErrorInvalidValue;
  long long vecs = chunk_bytes / 16;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // Blocks per rank: enough for one vector per thread, at most two
  // resident blocks per SM over the whole ring, at most the mesh's words.
  const long long want = (vecs + THREADS - 1) / THREADS;
  const long long cap = (long long)(per_sm < 2 ? per_sm : 2) * sms / n;
  long long nb = want < cap ? want : cap;
  if (nb > sig_blocks) nb = sig_blocks;
  if (nb < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int n_arg = n, stride = sig_blocks;
  void* args[] = {&t, &n_arg, &vecs, &stride, &epoch};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3((unsigned)nb, (unsigned)n),
                                    dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Every table holds n device pointers, one per
// rank, 16-byte aligned; sig[r] is the rank's (2, sig_blocks) signal
// words.  chunk_bytes = chunk D elt, a multiple of 16.
// delay_ns is null or n x n host ints.  Returns the cudaError_t of the
// launch.
//
// K2: in[r] a (chunk, D) block, out[r] (n chunk, D).  The copy moves bytes,
// so one entry point serves float32 and bfloat16.
extern "C" int ring_all_gather(const void* const* in, void* const* out,
                               void* const* sig, int n, long long chunk_bytes,
                               int sig_blocks, unsigned long long epoch,
                               const int* delay_ns, void* stream) {
  return launch(direct_all_gather_kernel, in, out, sig, n, chunk_bytes,
                sig_blocks, epoch, delay_ns, stream);
}

// K3: g[r] (n chunk, D), out[r] (chunk, D).
extern "C" int reduce_scatter_f32(const void* const* g, void* const* out,
                                  void* const* sig, int n,
                                  long long chunk_bytes, int sig_blocks,
                                  unsigned long long epoch,
                                  const int* delay_ns, void* stream) {
  return launch(reduce_scatter_for<AddF32>(n), g, out, sig, n, chunk_bytes,
                sig_blocks, epoch, delay_ns, stream);
}

extern "C" int reduce_scatter_bf16(const void* const* g, void* const* out,
                                   void* const* sig, int n,
                                   long long chunk_bytes, int sig_blocks,
                                   unsigned long long epoch,
                                   const int* delay_ns, void* stream) {
  return launch(reduce_scatter_for<AddBF16>(n), g, out, sig, n, chunk_bytes,
                sig_blocks, epoch, delay_ns, stream);
}
