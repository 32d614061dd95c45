// Ring all-gather (K2) and ring reduce-scatter (K3) for Hopper (sm_90a): the
// halo exchange of the graph-sharded 10k-node aggregation and its gradient.
//
// Replaces the TPU kernels of gcn_grabcut_tpu/parallel/ring_pallas.py:
//   K2  _all_gather_impl (body _ring_kernel): rank r holds one (chunk, D)
//       block and ends with all n blocks of the ring, concatenated;
//   K3  _reduce_scatter_impl (body _reduce_scatter_kernel): rank r holds a
//       (n chunk, D) cotangent g_r and ends with sum_j g_j[block r], partial
//       sums travelling rightward.  K3 is K2's gradient and K2 is K3's.
//
// Launch.  One cooperative launch per collective call, grid (B, n):
// blockIdx.y is the rank and blockIdx.x one of the B thread blocks of a
// rank.  Block b moves the same slice of the chunk (16-byte vectors
// [b per, (b + 1) per)) at every hop, so it waits only on block b of its
// left neighbour: one signal word per (rank, hop, block) and no grid-wide
// barrier.  A cooperative launch makes every block resident at once or
// fails, so blocks that spin on each other cannot deadlock because one of
// them was never scheduled.  The kernel reaches every rank's buffers only
// through the pointer table in its arguments: all ranks live on one card
// here, and a later launcher can fill the table with peer pointers.
//
// No slot reuse.  The Pallas kernel double-buffers through two comm slots and
// needs ack credits before it reuses one; ADVICE.md records the race of an
// ack sent before the slot's outgoing copy had read it.  Here every hop lands
// in its own place, written exactly once per call:
//   K2  rank r copies its block into out_r[r] and out_{r+1}[r] (hop 0).  At
//       hop s >= 1 it waits for its own hop-(s-1) signal and forwards
//       out_r[(r - s) mod n], already in its final place, to the same offset
//       of out_{r+1}.  It waits for the hop-(n-2) signal before it ends.
//   K3  hop 0 writes g_r[(r - 1) mod n] into recv_{r+1}[0].  Hop s >= 1 waits
//       for recv_r[s-1] and writes g_r[(r - s - 1) mod n] + recv_r[s-1]
//       straight into recv_{r+1}[s].  Then out_r = g_r[r] + recv_r[n-2].
//       Sums are taken in the input dtype (float32 adds; bf16 is widened,
//       added in float32 and rounded to nearest even at every hop), which is
//       the order and rounding of the plain version in parallel/ring.py.
// Without reuse no ack credit and no staging buffer is needed.  The TPU
// kernel's neighbour barrier made the peer's buffers live before the first
// remote write; here the wrapper allocates every rank's buffers before the
// single launch, on the stream the launch is ordered on.
//
// Signals.  The writer's threads store their data, the block synchronises,
// and one thread issues a system-scope fence and st.release.sys of the
// call's epoch into the neighbour's word.  The reader's thread 0 spins on
// ld.acquire.sys with __nanosleep back-off until the word reaches the
// epoch, then the block synchronises.  Data written by other blocks is read
// with ld.global.cg, so no stale L1 line of an earlier call is seen.  Every
// spin is bounded and ends in __trap(): a protocol fault fails the run
// instead of hanging it.  Epochs rise with every call on a mesh, so the words
// are never reset and a word left by an earlier call never satisfies a wait;
// calls on one mesh must therefore be ordered on one stream.  System scope
// keeps the code right for peer memory.
//
// Bound.  With E = chunk * D * elt bytes per block, K2 must read at least
// n E and write n^2 E; K3 must read at least n^2 E and write n E (its n^2
// chunk D adds are far below the card's rate).  On one H100 that is
// (n + n^2) E / 3.35 TB/s for either.  Across NVLink each rank sends
// (n - 1) E over one 450 GB/s direction: (n - 1) E / 450 GB/s.  This design
// moves more: K2 reads n (n - 1) E (forwarding reads what hop s-1 wrote) and
// writes n^2 E; K3 also reads and writes the n (n - 1) receive slots.
// Right first: TMA bulk copies and fewer blocks per hop are later work.
//
// Optional stress aid: a (rank, hop) table of nanosecond delays, null on the
// path, that stalls a rank's blocks before each hop to provoke races under
// timing skew.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RANKS = 16;
constexpr long long MAX_SPINS = 1LL << 22;   // ~4 s at the 1 us back-off cap

struct RingTable {
  const int4* in[MAX_RANKS];            // K2: block; K3: g (n chunk rows)
  int4* out[MAX_RANKS];                 // K2: n chunk rows; K3: chunk rows
  int4* recv[MAX_RANKS];                // K3: (n - 1, chunk) receive slots
  unsigned long long* sig[MAX_RANKS];   // (n - 1, sig_stride) words
  int delay_ns[MAX_RANKS][MAX_RANKS];   // before hop s of rank r; 0 = none
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

// Every thread's stores so far, then the word: the neighbour may read them.
__device__ __forceinline__ void signal_word(unsigned long long* word,
                                            unsigned long long epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release_sys(word, epoch);
  }
}

// Until the word carries this call's epoch; then the whole block goes on.
__device__ __forceinline__ void wait_word(const unsigned long long* word,
                                          unsigned long long epoch) {
  if (threadIdx.x == 0) {
    unsigned ns = 32;
    long long spins = 0;
    while (ld_acquire_sys(word) < epoch) {
      if (++spins > MAX_SPINS) __trap();
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __syncthreads();
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

// K2.  vecs = 16-byte vectors per chunk; the signal word of (rank r, hop s,
// block b) is sig[r][s * sig_stride + b].
__global__ void __launch_bounds__(THREADS)
ring_all_gather_kernel(RingTable t, int n, long long vecs, int sig_stride,
                       unsigned long long epoch) {
  const int r = blockIdx.y;
  const int b = blockIdx.x;
  const int right = (r + 1) % n;
  const long long per = (vecs + gridDim.x - 1) / gridDim.x;
  const long long v0 = min(vecs, b * per);
  const long long v1 = min(vecs, v0 + per);
  int4* mine = t.out[r];
  int4* next = t.out[right];
  const unsigned long long* my_sig = t.sig[r] + b;
  unsigned long long* right_sig = t.sig[right] + b;

  stall(t.delay_ns[r][0]);
  const long long own = (long long)r * vecs;
  for (long long v = v0 + threadIdx.x; v < v1; v += THREADS) {
    const int4 x = __ldcg(t.in[r] + v);
    __stcg(mine + own + v, x);
    __stcg(next + own + v, x);
  }
  signal_word(right_sig, epoch);

  for (int s = 1; s <= n - 2; ++s) {
    wait_word(my_sig + (long long)(s - 1) * sig_stride, epoch);
    stall(t.delay_ns[r][s]);
    const long long off = (long long)(((r - s) % n + n) % n) * vecs;
    for (long long v = v0 + threadIdx.x; v < v1; v += THREADS)
      __stcg(next + off + v, __ldcg(mine + off + v));
    signal_word(right_sig + (long long)s * sig_stride, epoch);
  }
  wait_word(my_sig + (long long)(n - 2) * sig_stride, epoch);
}

// K3, with Op::add the input dtype's elementwise sum of two vectors.
template <class Op>
__global__ void __launch_bounds__(THREADS)
ring_reduce_scatter_kernel(RingTable t, int n, long long vecs,
                           int sig_stride, unsigned long long epoch) {
  const int r = blockIdx.y;
  const int b = blockIdx.x;
  const int right = (r + 1) % n;
  const long long per = (vecs + gridDim.x - 1) / gridDim.x;
  const long long v0 = min(vecs, b * per);
  const long long v1 = min(vecs, v0 + per);
  const int4* g = t.in[r];
  const int4* mine = t.recv[r];
  int4* next = t.recv[right];
  const unsigned long long* my_sig = t.sig[r] + b;
  unsigned long long* right_sig = t.sig[right] + b;

  stall(t.delay_ns[r][0]);
  const long long first = (long long)((r - 1 + n) % n) * vecs;
  for (long long v = v0 + threadIdx.x; v < v1; v += THREADS)
    __stcg(next + v, __ldcg(g + first + v));
  signal_word(right_sig, epoch);

  for (int s = 1; s <= n - 2; ++s) {
    wait_word(my_sig + (long long)(s - 1) * sig_stride, epoch);
    stall(t.delay_ns[r][s]);
    const long long off = (long long)(((r - s - 1) % n + n) % n) * vecs;
    const int4* part = mine + (long long)(s - 1) * vecs;
    int4* dst = next + (long long)s * vecs;
    for (long long v = v0 + threadIdx.x; v < v1; v += THREADS)
      __stcg(dst + v, Op::add(__ldcg(g + off + v), __ldcg(part + v)));
    signal_word(right_sig + (long long)s * sig_stride, epoch);
  }

  wait_word(my_sig + (long long)(n - 2) * sig_stride, epoch);
  stall(t.delay_ns[r][n - 1]);
  const long long own = (long long)r * vecs;
  const int4* part = mine + (long long)(n - 2) * vecs;
  for (long long v = v0 + threadIdx.x; v < v1; v += THREADS)
    __stcg(t.out[r] + v, Op::add(__ldcg(g + own + v), __ldcg(part + v)));
}

using Kernel = void (*)(RingTable, int, long long, int, unsigned long long);

int fill(RingTable& t, const void* const* in, void* const* out,
         void* const* recv, void* const* sig, int n, const int* delay_ns) {
  if (n < 2 || n > MAX_RANKS) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < MAX_RANKS; ++r) {
    const bool on = r < n;
    t.in[r] = on ? static_cast<const int4*>(in[r]) : nullptr;
    t.out[r] = on ? static_cast<int4*>(out[r]) : nullptr;
    t.recv[r] = on && recv ? static_cast<int4*>(recv[r]) : nullptr;
    t.sig[r] = on ? static_cast<unsigned long long*>(sig[r]) : nullptr;
    for (int s = 0; s < MAX_RANKS; ++s)
      t.delay_ns[r][s] = on && s < n && delay_ns ? delay_ns[r * n + s] : 0;
  }
  return 0;
}

int launch(Kernel kernel, RingTable& t, int n, long long chunk_bytes,
           int sig_blocks, unsigned long long epoch, void* stream) {
  if (chunk_bytes <= 0 || chunk_bytes % 16 || sig_blocks < 1)
    return (int)cudaErrorInvalidValue;
  long long vecs = chunk_bytes / 16;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
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

int reduce_scatter(Kernel kernel, const void* const* g, void* const* recv,
                   void* const* out, void* const* sig, int n,
                   long long chunk_bytes, int sig_blocks,
                   unsigned long long epoch, const int* delay_ns,
                   void* stream) {
  RingTable t;
  const int err = fill(t, g, out, recv, sig, n, delay_ns);
  if (err) return err;
  return launch(kernel, t, n, chunk_bytes, sig_blocks, epoch, stream);
}

}  // namespace

// Plain C interface for ctypes.  Every table holds n device pointers, one per
// rank, 16-byte aligned: in[r] a (chunk, D) block, out[r] (n chunk, D), sig[r]
// the rank's (n - 1, sig_blocks) signal words.  chunk_bytes = chunk D elt,
// a multiple of 16.  delay_ns is null or n x n host ints (rank, hop).  The
// copy moves bytes, so one entry point serves float32 and bfloat16.  Returns
// the cudaError_t of the launch.
extern "C" int ring_all_gather(const void* const* in, void* const* out,
                               void* const* sig, int n, long long chunk_bytes,
                               int sig_blocks, unsigned long long epoch,
                               const int* delay_ns, void* stream) {
  RingTable t;
  const int err = fill(t, in, out, nullptr, sig, n, delay_ns);
  if (err) return err;
  return launch(ring_all_gather_kernel, t, n, chunk_bytes, sig_blocks, epoch,
                stream);
}

// g[r] (n chunk, D), recv[r] (n - 1, chunk, D) scratch, out[r] (chunk, D);
// the rest as above.
extern "C" int ring_reduce_scatter_f32(const void* const* g,
                                       void* const* recv, void* const* out,
                                       void* const* sig, int n,
                                       long long chunk_bytes, int sig_blocks,
                                       unsigned long long epoch,
                                       const int* delay_ns, void* stream) {
  return reduce_scatter(ring_reduce_scatter_kernel<AddF32>, g, recv, out, sig,
                        n, chunk_bytes, sig_blocks, epoch, delay_ns, stream);
}

extern "C" int ring_reduce_scatter_bf16(const void* const* g,
                                        void* const* recv, void* const* out,
                                        void* const* sig, int n,
                                        long long chunk_bytes, int sig_blocks,
                                        unsigned long long epoch,
                                        const int* delay_ns, void* stream) {
  return reduce_scatter(ring_reduce_scatter_kernel<AddBF16>, g, recv, out,
                        sig, n, chunk_bytes, sig_blocks, epoch, delay_ns,
                        stream);
}
