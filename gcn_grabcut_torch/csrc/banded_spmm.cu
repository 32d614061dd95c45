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
// What bounds it on an H100 SXM: at the main path's shapes (n_pad = 10 112,
// R = 128, K = 4, D = 128) the band is 10.4 MB in bf16, x 2.6 MB and the
// fp32 output 5.2 MB, ~18 MB or ~5.4 us at 3.35 TB/s, against 2 n_pad K R D
// = 1.33 GFLOP, ~1.3 us at the 989 TFLOP/s bf16 tensor-core peak: memory
// bound in bf16.  In fp32 the same work is 31 MB (~9.3 us) but 1.33 GFLOP at
// the 67 TFLOP/s fp32 FMA peak is ~20 us: operation bound.
//
// Design (right first, fast later): one thread block per (64-row tile, 64-
// column tile of D).  The K*R-long reduction runs as a loop over 32-deep
// shared-memory tiles of the band and of x, converted to fp32 on load, with
// a 4x4 fp32 register accumulator per thread (plain FMA; every band value is
// read once, each x slab row K times from L2).  bf16 products are exact in
// fp32, so the bf16 instantiation differs from a tensor-core product only in
// summation order.  Tensor cores (wgmma) and TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;    // destination rows per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 32;    // reduction depth per shared-memory tile
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
banded_spmm_kernel(const T* __restrict__ band, const T* __restrict__ x,
                   float* __restrict__ out, int n_pad, int n_x, int R,
                   int K, int D) {
  // +1 column of padding: the transposed band store hits 32 banks.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;          // first destination row
  const int d0 = blockIdx.y * BN;          // first output column
  const int b = r0 / R;                    // destination row block
  const int src0 = (b - K / 2) * R;        // x row of reduction index 0

  const int ty = tid / 16;                 // rows ty*4 .. ty*4+3
  const int tx = tid % 16;                 // cols tx, tx+16, tx+32, tx+48

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  const int depth = K * R;
  for (int t0 = 0; t0 < depth; t0 += BK) {
    const int k = t0 / R;                  // BK divides R: one k per tile
    const int s0 = t0 % R;
    // Band tile: rows r0..r0+BM of sub-block k, columns s0..s0+BK.
    // Consecutive threads read consecutive s (coalesced).
#pragma unroll
    for (int j = 0; j < (BM * BK) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int i = idx / BK;
      const int tt = idx % BK;
      const long long g =
          ((long long)k * n_pad + r0 + i) * (long long)R + s0 + tt;
      As[tt][i] = to_f32(band[g]);
    }
    // x tile: reduction rows t0..t0+BK, columns d0..d0+BN; rows outside
    // [0, n_x) and columns past D read as zero.
#pragma unroll
    for (int j = 0; j < (BK * BN) / THREADS; ++j) {
      const int idx = tid + j * THREADS;
      const int tt = idx / BN;
      const int c = idx % BN;
      const int row = src0 + t0 + tt;
      const int col = d0 + c;
      float v = 0.f;
      if (row >= 0 && row < n_x && col < D)
        v = to_f32(x[(long long)row * D + col]);
      Bs[tt][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < BK; ++tt) {
      float a[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = As[tt][ty * 4 + m];
#pragma unroll
      for (int n = 0; n < 4; ++n) bv[n] = Bs[tt][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], bv[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int row = r0 + ty * 4 + m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int col = d0 + tx + 16 * n;
      if (col < D) out[(long long)row * D + col] = acc[m][n];
    }
  }
}

template <typename T>
int launch(const void* band, const void* x, float* out, int n_pad, int n_x,
           int R, int K, int D, void* stream) {
  dim3 grid(n_pad / BM, (D + BN - 1) / BN);
  banded_spmm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(band), static_cast<const T*>(x), out, n_pad, n_x,
      R, K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes.  Shapes: band (K, n_pad, R), x (n_x, D),
// out (n_pad, D) fp32; all contiguous.  The caller guarantees
// n_pad % R == 0 and R % 64 == 0.  Returns the cudaError_t of the launch.
extern "C" int banded_spmm_bf16(const void* band, const void* x, float* out,
                                int n_pad, int n_x, int R, int K, int D,
                                void* stream) {
  return launch<__nv_bfloat16>(band, x, out, n_pad, n_x, R, K, D, stream);
}

extern "C" int banded_spmm_f32(const void* band, const void* x, float* out,
                               int n_pad, int n_x, int R, int K, int D,
                               void* stream) {
  return launch<float>(band, x, out, n_pad, n_x, R, K, D, stream);
}
