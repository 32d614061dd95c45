// Banded-dense SpMM for Hopper (sm_90a): the message-passing product of the
// 10k-superpixel GCN path.
//
// Replaces the TPU kernel gcn_grabcut_tpu/ops/spmm.py:_banded_spmm_pallas
// (body _make_pallas_kernel).  For destination block b of R rows:
//
//   out[bR + i, :] = sum_k sum_s band[k, bR + i, s] * x[(b + k - K/2) R + s, :]
//
// i.e. one (R x K*R) @ (K*R x D) product per row block, whose right operand
// is the contiguous slab of x rows [(b - K/2) R, (b - K/2 + K) R).  Rows of
// x outside [0, n_x) read as zero, which stands for the TPU kernel's
// zero-padded copy `xpad` without materialising it.
//
// What bounds it on an H100 SXM.  At the main path's shapes (n_pad =
// 10 112, R = 128, K = 4, D = 128) the band is 10.4 MB in bf16, x 2.6 MB and
// the fp32 output 5.2 MB: 18.1 MB, ~5.4 us at 3.35 TB/s, against 2 n_pad K
// R D = 1.33 GFLOP, ~1.3 us at the 989 TFLOP/s bf16 tensor-core peak (73
// FLOP per byte, far below the ~295 where the tensor cores would bind): in
// bf16 it is bound by bytes.  In fp32 the same work moves 31 MB (~9.3 us)
// but 1.33 GFLOP at the 67 TFLOP/s fp32 FMA peak is ~20 us: operation
// bound, and no TF32 is allowed (JAX precision="highest").
//
// Design.  One block per (64-row tile, BN-column tile of D), BN the smallest
// of 64 / 128 / 256 that holds D, so for D <= 256 every band value is read
// from device memory by exactly one block.  The K*R-deep reduction streams
// through a ring of shared-memory stages, each 128 bytes of every band row of
// the tile and the matching 64 rows of x.  Rows of x outside [0, n_x) and
// columns past D read as zero.  At the path's shapes: 158 blocks, each
// reading 64 KB of band once, its 128 KB x slab (which the neighbouring
// tiles reread from L2) and writing 32 KB of fp32 out.
//
//   bf16 (the path): one warpgroup (128 threads) per block on the tensor
//   cores, wgmma.mma_async m64n64k16 with bf16 operands from shared memory
//   and fp32 accumulators in registers.  The band tile (rows x s, s
//   contiguous) is a K-major A and the x tile (s x D, D contiguous) an
//   MN-major ("transposed") B, both in the 128-byte swizzle that the wgmma
//   descriptors name: the 16-byte chunk c of a 128-byte row r lies at chunk
//   c ^ (r % 8), in 1024-byte atoms of 8 rows.  A's atoms stack along M; B
//   is cut into 64-column blocks of 8 KB, one m64n64k16 each, whose atoms
//   stack along K.  TMA fills the ring: thread 0 keeps STAGES tiles in
//   flight, each stage's arrival counted on its mbarrier; TMA writes that
//   same swizzle and zero-fills out-of-bounds rows and columns.  Why these
//   choices: an mma.sync + ldmatrix version of this kernel ran at ~2.6x the
//   byte bound (8 warps reloading their fragments from shared memory, the
//   legacy tensor-core path), and filling the ring with cp.async left it
//   there: 16-byte copies from every thread could not pull a block's 192 KB
//   fast enough.  TMA moves the same bytes with a few instructions.
//   fp32: exact fp32 FMA (no TF32), 128 threads each holding an 8 x BN/16
//   register tile fed by float4 shared loads, the ring filled by 16-byte
//   cp.async.cg copies (src-size 0 for the zero fill) into rows padded by 16
//   bytes against bank conflicts; cp.async writes through the generic
//   proxy, so each thread fences to the async proxy before the barrier that
//   hands over a stage.
// bf16 products are exact in fp32, so both differ from the plain version
// only in summation order.  The epilogue stages the tile in shared memory
// and writes fp32 rows with 16-byte stores, masked at D.
//
// Rows whose width is not a multiple of 16 bytes (D = 19 in bf16, say), or
// unaligned base pointers, take a narrow variant of the same kernel: element
// loads through registers into the same shared layout, the same tensor-core
// or FMA compute.

#include <cuda.h>            // CUtensorMap (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 4;      // tiles the shared-memory ring holds

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// This thread's shared-memory writes -> visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// A wgmma shared-memory descriptor: 128-byte swizzle, byte offsets >> 4.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// d (64 x 64 fp32, the warpgroup's fragment) += A (64 x 16 bf16, K-major)
// * B (16 x 64 bf16, MN-major).
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of TMA writes before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// A 2-D box of `map` at (c0 inner, c1 outer) -> dst, completing on bar.
// Coordinates outside the tensor, negative ones included, read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1),
         "r"(smem_addr(bar)) : "memory");
}

// bf16 on the tensor cores, one warpgroup.  Shared layout per stage: A (64
// rows x 64 s, 128 bytes a row) then B (BN/64 blocks of 64 s rows x 64
// columns), both swizzled; element offsets below.
template <int BN_>
struct TensorCoreBF16 {
  using T = __nv_bfloat16;
  static constexpr int BM = 64, BN = BN_;
  static constexpr int THREADS = 128;
  static constexpr int BK = 64;                  // 128 bytes of a band row
  static constexpr int A_ELTS = BM * BK;
  static constexpr int STAGE_ELTS = A_ELTS + BK * BN;
  static constexpr int C_LD = BN + 4;            // fp32 out tile row
  static constexpr int ALIGN = 1024;             // swizzle atoms

  static __device__ __forceinline__ int a_off(int i, int c) {
    return i * BK + ((((c >> 3) ^ i) & 7) << 3) + (c & 7);
  }
  static __device__ __forceinline__ int b_off(int kk, int c) {
    return (c >> 6) * (BK * 64) + kk * 64 + ((((c >> 3) ^ kk) & 7) << 3) +
           (c & 7);
  }

  float acc[BN / 64][32];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[j][q] = 0.f;
  }

  __device__ __forceinline__ void step(const T* sA, const T* sB) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // A: +32 bytes per 16-deep step inside the 128-byte rows; 8-row atoms
      // 1024 bytes apart.  B: one wgmma per 64-column block, 16 rows of 128
      // bytes per step, 8-row atoms 1024 bytes apart (the one stride a
      // 64-wide MN-major operand has, given as both offsets).
      const uint64_t da = smem_desc(sA + kk, 16, 1024);
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        wgmma_m64n64k16(acc[j], da,
                        smem_desc(sB + j * (BK * 64) + kk * 64, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
  }

  // Accumulators -> the fp32 out tile in shared memory: warp w holds rows
  // w*16 + lane/4 (+ 8), columns 8 t + 2 (lane % 4) of each 64-column block.
  __device__ __forceinline__ void stash(float* sC) const {
    const int lane = threadIdx.x & 31;
    const int row = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int col = j * 64 + t * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(sC + row * C_LD + col) =
            make_float2(acc[j][4 * t], acc[j][4 * t + 1]);
        *reinterpret_cast<float2*>(sC + (row + 8) * C_LD + col) =
            make_float2(acc[j][4 * t + 2], acc[j][4 * t + 3]);
      }
  }
};

// fp32 on the FMA units: thread (ty, tx) of an 8 x 16 grid owns rows
// ty + 8 m (m < 8) and columns g*64 + tx*4 .. +4 for g < BN/64: an 8 x BN/16
// register tile, 16 float4 shared loads for every 256 FMAs.  Rows of both
// tiles are padded by 16 bytes against bank conflicts.
template <int BN_>
struct FmaF32 {
  using T = float;
  static constexpr int BM = 64, BN = BN_;
  static constexpr int THREADS = 128;
  static constexpr int BK = 32;                  // 128 bytes of a band row
  static constexpr int A_LD = BK + 4, B_LD = BN + 4;
  static constexpr int A_ELTS = BM * A_LD;
  static constexpr int STAGE_ELTS = A_ELTS + BK * B_LD;
  static constexpr int C_LD = BN + 4;
  static constexpr int ALIGN = 16;
  static constexpr int G = BN / 64;

  static __device__ __forceinline__ int a_off(int i, int c) {
    return i * A_LD + c;
  }
  static __device__ __forceinline__ int b_off(int kk, int c) {
    return kk * B_LD + c;
  }

  float acc[8][G][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][g][q] = 0.f;
  }

  __device__ __forceinline__ void step(const float* sA, const float* sB) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        a[m] = *reinterpret_cast<const float4*>(sA + (ty + 8 * m) * A_LD +
                                                kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 b = *reinterpret_cast<const float4*>(
              sB + (kk + q) * B_LD + g * 64 + tx * 4);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float av = q == 0 ? a[m].x : q == 1 ? a[m].y
                             : q == 2 ? a[m].z : a[m].w;
            acc[m][g][0] = fmaf(av, b.x, acc[m][g][0]);
            acc[m][g][1] = fmaf(av, b.y, acc[m][g][1]);
            acc[m][g][2] = fmaf(av, b.z, acc[m][g][2]);
            acc[m][g][3] = fmaf(av, b.w, acc[m][g][3]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void stash(float* sC) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int g = 0; g < G; ++g)
        *reinterpret_cast<float4*>(sC + (ty + 8 * m) * C_LD + g * 64 +
                                   tx * 4) =
            make_float4(acc[m][g][0], acc[m][g][1], acc[m][g][2],
                        acc[m][g][3]);
  }
};

template <class P>
constexpr int smem_bytes() {
  constexpr int ring = STAGES * P::STAGE_ELTS * (int)sizeof(typename P::T);
  constexpr int out = P::BM * P::C_LD * 4;
  return (ring > out ? ring : out) + P::ALIGN;
}

template <class P>
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + (P::ALIGN - smem_addr(raw) % P::ALIGN) % P::ALIGN;
}

// The accumulators -> out rows r0 .. r0+BM, columns d0 .. d0+BN (< D),
// staged through shared memory (the free ring) for 16-byte stores.
template <class P>
__device__ __forceinline__ void store_tile(const P& c, unsigned char* smem,
                                           float* __restrict__ out, int r0,
                                           int d0, int D) {
  constexpr int BM = P::BM, BN = P::BN;
  float* sC = reinterpret_cast<float*>(smem);
  c.stash(sC);
  __syncthreads();
  const bool vec_out = (D & 3) == 0;
  for (int v = threadIdx.x; v < BM * BN / 4; v += P::THREADS) {
    const int i = v / (BN / 4), cc = (v % (BN / 4)) * 4;
    const int col = d0 + cc;
    if (col >= D) continue;
    float* o = out + (long long)(r0 + i) * D + col;
    const float* s = sC + i * P::C_LD + cc;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(s);
    } else {
      for (int e = 0; e < 4 && col + e < D; ++e) o[e] = s[e];
    }
  }
}

// Stage `tile` of the reduction into (sA, sB): band rows r0..r0+BM of
// sub-block k, columns s0..s0+BK, and x rows src0 + t0 .. + BK, columns
// d0..d0+BN.
template <class P, bool VEC>
__device__ __forceinline__ void load_tile(typename P::T* sA,
                                          typename P::T* sB,
                                          const typename P::T* band,
                                          const typename P::T* x, int tile,
                                          int r0, int src0, int d0, int n_pad,
                                          int n_x, int R, int D) {
  using T = typename P::T;
  constexpr int BM = P::BM, BN = P::BN, BK = P::BK;
  constexpr int VE = 16 / sizeof(T);             // elements per vector
  const int t0 = tile * BK;
  const int k = t0 / R;                          // BK divides R
  const T* a_src = band + ((long long)k * n_pad + r0) * R + (t0 - k * R);
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int v = tid; v < BM * BK / VE; v += P::THREADS) {
      const int i = v / (BK / VE), c = (v % (BK / VE)) * VE;
      cp_async16(sA + P::a_off(i, c), a_src + (long long)i * R + c, 16);
    }
#pragma unroll
    for (int v = tid; v < BK * BN / VE; v += P::THREADS) {
      const int kk = v / (BN / VE), c = (v % (BN / VE)) * VE;
      const int row = src0 + t0 + kk, col = d0 + c;
      const bool ok = row >= 0 && row < n_x && col < D;
      // A zero-filled copy still names a valid address: the band's.
      const T* src = ok ? x + (long long)row * D + col : band;
      cp_async16(sB + P::b_off(kk, c), src, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BM * BK; e += P::THREADS) {
      const int i = e / BK, c = e % BK;
      sA[P::a_off(i, c)] = a_src[(long long)i * R + c];
    }
    for (int e = tid; e < BK * BN; e += P::THREADS) {
      const int kk = e / BN, c = e % BN;
      const int row = src0 + t0 + kk, col = d0 + c;
      sB[P::b_off(kk, c)] = row >= 0 && row < n_x && col < D
                                ? x[(long long)row * D + col] : zero<T>();
    }
  }
}

template <class P, bool VEC>
__global__ void __launch_bounds__(P::THREADS)
banded_spmm_kernel(const typename P::T* __restrict__ band,
                   const typename P::T* __restrict__ x,
                   float* __restrict__ out, int n_pad, int n_x, int R, int K,
                   int D) {
  using T = typename P::T;
  constexpr int BM = P::BM, BN = P::BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem<P>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem);

  const int r0 = blockIdx.x * BM;             // first destination row
  const int d0 = blockIdx.y * BN;             // first output column
  const int src0 = (r0 / R - K / 2) * R;      // x row of reduction index 0
  const int n_tiles = K * R / P::BK;

  P c;
  c.init();

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      T* st = ring + s * P::STAGE_ELTS;
      load_tile<P, VEC>(st, st + P::A_ELTS, band, x, s, r0, src0, d0, n_pad,
                        n_x, R, D);
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();    // this thread's copies of tile t landed
    fence_proxy_async();
    __syncthreads();                // everyone's, and tile t-1 is consumed
    const int next = t + STAGES - 1;
    if (next < n_tiles) {
      T* st = ring + (next % STAGES) * P::STAGE_ELTS;
      load_tile<P, VEC>(st, st + P::A_ELTS, band, x, next, r0, src0, d0,
                        n_pad, n_x, R, D);
    }
    cp_async_commit();
    const T* st = ring + (t % STAGES) * P::STAGE_ELTS;
    c.step(st, st + P::A_ELTS);
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the out tile
  store_tile(c, smem, out, r0, d0, D);
}

// The bf16 path with TMA: thread 0 keeps STAGES tiles in flight, each
// stage's arrival counted by its mbarrier (one expect_tx arrival, the box
// bytes).  TMA writes the 128-byte swizzle that the wgmma descriptors read
// and zero-fills rows of x outside [0, n_x) and columns past D.

template <class P>
__global__ void __launch_bounds__(P::THREADS)
banded_spmm_tma_kernel(const __grid_constant__ CUtensorMap band_map,
                       const __grid_constant__ CUtensorMap x_map,
                       float* __restrict__ out, int n_pad, int R, int K,
                       int D) {
  using T = typename P::T;
  constexpr int BM = P::BM, BN = P::BN, BK = P::BK;
  constexpr unsigned TX = (BM + BN) * BK * sizeof(T);   // bytes per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t full[STAGES];
  unsigned char* smem = aligned_smem<P>(smem_raw);
  T* ring = reinterpret_cast<T*>(smem);

  const int r0 = blockIdx.x * BM;             // first destination row
  const int d0 = blockIdx.y * BN;             // first output column
  const int src0 = (r0 / R - K / 2) * R;      // x row of reduction index 0
  const int n_tiles = K * R / BK;

  // Thread 0: band rows r0..r0+BM of sub-block k, columns s0..s0+BK, and
  // x rows src0+t0 .. +BK in 64-column boxes, into the tile's stage.
  auto issue = [&](int tile) {
    const int s = tile % STAGES, t0 = tile * BK, k = t0 / R;
    T* st = ring + s * P::STAGE_ELTS;
    mbar_expect_tx(&full[s], TX);
    tma_load_2d(st, &band_map, &full[s], t0 - k * R, k * n_pad + r0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_2d(st + P::A_ELTS + j * BK * 64, &x_map, &full[s], d0 + j * 64,
                  src0 + t0);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    fence_mbar_init();
    for (int s = 0; s < STAGES && s < n_tiles; ++s) issue(s);
  }
  __syncthreads();

  P c;
  c.init();
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const T* st = ring + s * P::STAGE_ELTS;
    c.step(st, st + P::A_ELTS);
    __syncthreads();                // every warpgroup is done with stage s
    if (threadIdx.x == 0 && t + STAGES < n_tiles) issue(t + STAGES);
  }
  store_tile(c, smem, out, r0, d0, D);
}

// How a kernel fills its ring: element loads (any width), cp.async (rows
// of 16-byte multiples), TMA (bf16 rows of 16-byte multiples).
enum Load { NARROW, CP_ASYNC, TMA };

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A 2-D bf16 tensor map (inner extent, outer extent, row pitch in bytes)
// read in boxes of 64 x box_rows with the 128-byte swizzle; reads outside
// the tensor give zeros.
int bf16_map(CUtensorMap* map, const void* base, uint64_t inner,
             uint64_t outer, uint64_t pitch, uint32_t box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class P, Load L>
int launch_tile(const void* band, const void* x, float* out, int n_pad,
                int n_x, int R, int K, int D, cudaStream_t stream) {
  using T = typename P::T;
  const dim3 grid(n_pad / P::BM, (D + P::BN - 1) / P::BN);
  if constexpr (L == TMA) {
    CUtensorMap band_map, x_map;
    int err = bf16_map(&band_map, band, R, (uint64_t)K * n_pad,
                       (uint64_t)R * 2, P::BM);
    if (err == 0) err = bf16_map(&x_map, x, D, n_x, (uint64_t)D * 2, 64);
    if (err != 0) return err;
    auto kernel = banded_spmm_tma_kernel<P>;
    constexpr int smem = smem_bytes<P>();
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, P::THREADS, smem, stream>>>(band_map, x_map, out, n_pad,
                                               R, K, D);
  } else {
    auto kernel = banded_spmm_kernel<P, L == CP_ASYNC>;
    constexpr int smem = smem_bytes<P>();
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, P::THREADS, smem, stream>>>(
        static_cast<const T*>(band), static_cast<const T*>(x), out, n_pad,
        n_x, R, K, D);
  }
  return (int)cudaGetLastError();
}

// The column tile: the smallest of 64 / 128 / 256 that holds D.
template <template <int> class P, Load L>
int launch_cols(const void* band, const void* x, float* out, int n_pad,
                int n_x, int R, int K, int D, cudaStream_t s) {
  if (D <= 64)
    return launch_tile<P<64>, L>(band, x, out, n_pad, n_x, R, K, D, s);
  if (D <= 128)
    return launch_tile<P<128>, L>(band, x, out, n_pad, n_x, R, K, D, s);
  return launch_tile<P<256>, L>(band, x, out, n_pad, n_x, R, K, D, s);
}

// Rows of 16-byte multiples from 16-byte aligned bases take the wide loads.
bool wide_ok(const void* band, const void* x, int n_x, int D, int elt) {
  return n_x > 0 && (D * elt) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(band) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

}  // namespace

// Plain C interface for ctypes.  Shapes: band (K, n_pad, R), x (n_x, D),
// out (n_pad, D) fp32; all contiguous, out 16-byte aligned.  The caller
// guarantees n_pad % R == 0 and R % 64 == 0.  Returns the cudaError_t of the
// launch.
extern "C" int banded_spmm_bf16(const void* band, const void* x, float* out,
                                int n_pad, int n_x, int R, int K, int D,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return wide_ok(band, x, n_x, D, 2)
             ? launch_cols<TensorCoreBF16, TMA>(band, x, out, n_pad, n_x, R,
                                                K, D, s)
             : launch_cols<TensorCoreBF16, NARROW>(band, x, out, n_pad, n_x,
                                                   R, K, D, s);
}

extern "C" int banded_spmm_f32(const void* band, const void* x, float* out,
                               int n_pad, int n_x, int R, int K, int D,
                               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return wide_ok(band, x, n_x, D, 4)
             ? launch_cols<FmaF32, CP_ASYNC>(band, x, out, n_pad, n_x, R, K,
                                             D, s)
             : launch_cols<FmaF32, NARROW>(band, x, out, n_pad, n_x, R, K, D,
                                           s);
}
