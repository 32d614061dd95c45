// Connected components of a batch of binary masks for Hopper (sm_90a): the
// port's connected_components (ops/connected.py) on the card, every sweep
// and every image's convergence test in one launch.
//
// Replaces no Pallas kernel.  In the JAX package the labelling is XLA code
// (gcn_grabcut_tpu/ops/connected.py connected_components): a
// lax.while_loop of sweeps whose convergence test runs on the device, which
// the clean-up (_clean_mask_jit) vmaps over the batch.  Eager PyTorch turns
// that loop into a Python loop of small kernels with a host sync per sweep
// (ops/connected.py connected_components_plain).  This kernel keeps the
// loop and its test on the card.
//
// What it computes: the plain version's labels, bit for bit, for B
// same-size (H, W) masks.  Labels start as the linear index (y W + x) at
// foreground pixels and H W at background.  A sweep is
//   1. the min stencil: each foreground pixel takes the minimum of its own
//      label and its 8 (or 4) neighbours' (out of the image: none);
//   2. the run-min along rows: each foreground pixel takes the minimum of
//      (1) over its maximal run of foreground pixels in its row;
//   3. the same along columns, on (2);
// and an image changed in a sweep if (3) is below its labels before the
// sweep anywhere.  An image runs sweeps until one changes nothing (it is at
// its fixpoint, where the plain version's further sweeps change nothing)
// or max_iters sweeps are done: the plain version's Jacobi sweeps, so the
// labels at the cap are its labels too.
//
// Bound.  Bytes: the mask read once (1 byte a pixel) and the labels
// written once (4 bytes), over 3.35 TB/s on an H100; a sweep of the plain
// version moves more, and this kernel reads and writes the labels and two
// scratch planes every sweep (chip_smoke reports its sweeps).  Barriers:
// one after the set-up and two a sweep.
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with as many blocks of 256 threads as fit on the
// SMs at once; cooperative_groups' grid sync separates the passes.  A run
// pass gives one warp one line (a row of one image, or a column): the warp
// walks the line in chunks of 32 pixels, twice.  Backward, a segmented
// suffix-min over each chunk by warp shuffles (a background pixel ends a
// run), carried into the next chunk to the left, is stored in a scratch
// plane; forward, the segmented prefix-min, carried to the right, and the
// minimum of the two is the run's minimum.  The row pass computes the
// stencil of (1) from the labels as it loads (so (1) needs no pass of its
// own) and writes the rows' minima to a scratch plane; the column pass
// reads that plane, writes the labels and tests them against the old ones.
// An image that did not change in a sweep is not swept again: each image
// stamps the sweep in which it changed (two slots, read and written in
// alternate sweeps, so no slot is cleared).  Data written in the launch is
// read by ld.global.cg (L2) after a grid barrier, whose fence orders it
// after the writes before the barrier.  The wrapper allocates every buffer;
// the kernel allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Job {
  const uint8_t* mask;   // (B, H, W) bool
  int* lab;              // (B, H, W) labels, the output
  int* rows;             // (B, H, W) the row pass's minima
  int* suffix;           // (B, H, W) the column pass's suffix minima
  int* ctrl;             // 2 B stamps, then the sweeps run
  int B, H, W, conn, max_iters;
};

template <class T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

// Image b runs sweep s if s == 0 or it changed in sweep s - 1, which wrote
// s into slot (s - 1) & 1.
__device__ __forceinline__ bool runs(const Job& j, int b, int s) {
  return s == 0 || ld(j.ctrl + ((s - 1) & 1) * j.B + b) == s;
}

// The min stencil (1) at foreground pixel (y, x) of image b's labels L.
__device__ __forceinline__ int stencil(const Job& j, const int* L, int y,
                                       int x) {
  int v = ld(L + y * j.W + x);
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = y + dy;
    if (yy < 0 || yy >= j.H) continue;
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx;
      if ((dy == 0 && dx == 0) || xx < 0 || xx >= j.W) continue;
      if (j.conn == 4 && dy != 0 && dx != 0) continue;
      v = min(v, ld(L + yy * j.W + xx));
    }
  }
  return v;
}

// The run-min of one line of n pixels by one warp.  at(i) gives pixel i's
// (value, is foreground); the suffix minima go to tmp[i * stride] and
// finish(i, min) receives each pixel's run minimum (bg at background).
// A background pixel holds bg, the largest label, and ends a run.
template <class At, class Finish>
__device__ void line_run_min(int lane, int n, int bg, At at, int* tmp,
                             long long stride, Finish finish) {
  const int chunks = (n + 31) / 32;
  int carry = bg;
  for (int c = chunks - 1; c >= 0; --c) {
    const int i = c * 32 + lane;
    bool fg = false;
    int v = bg;
    if (i < n) at(i, v, fg);
    // (m, f): the minimum from this lane to the first background pixel at
    // or after it within the span combined so far, and whether the span
    // holds a background pixel.
    int m = fg ? v : bg;
    int f = !fg;
    for (int d = 1; d < 32; d <<= 1) {
      const int om = __shfl_down_sync(FULL, m, d);
      const int of = __shfl_down_sync(FULL, f, d);
      if (lane + d < 32 && !f) {
        m = min(m, om);
        f = of;
      }
    }
    if (!f) m = min(m, carry);
    carry = __shfl_sync(FULL, m, 0);
    if (i < n) tmp[i * stride] = m;
  }
  carry = bg;
  for (int c = 0; c < chunks; ++c) {
    const int i = c * 32 + lane;
    bool fg = false;
    int v = bg;
    if (i < n) at(i, v, fg);
    int m = fg ? v : bg;
    int f = !fg;
    for (int d = 1; d < 32; d <<= 1) {
      const int om = __shfl_up_sync(FULL, m, d);
      const int of = __shfl_up_sync(FULL, f, d);
      if (lane >= d && !f) {
        m = min(m, om);
        f = of;
      }
    }
    if (!f) m = min(m, carry);
    carry = __shfl_sync(FULL, m, 31);
    // The suffix minimum was stored by this lane: its own write.
    if (i < n) finish(i, min(m, tmp[i * stride]));
  }
}

__global__ void __launch_bounds__(THREADS) mask_components_kernel(Job j) {
  cg::grid_group g = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * WARPS;
  const int hw = j.H * j.W;
  const int bg = hw;
  const long long n = (long long)j.B * hw;

  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS)
    j.lab[p] = j.mask[p] ? (int)(p % hw) : bg;
  g.sync();

  int s = 0;
  for (; s < j.max_iters; ++s) {
    bool any = false;
    for (int b = 0; b < j.B && !any; ++b) any = runs(j, b, s);
    if (!any) break;

    // Rows: the stencil on the labels, then the run-min; into j.rows.
    for (long long r = warp; r < (long long)j.B * j.H; r += warps) {
      const int b = (int)(r / j.H), y = (int)(r % j.H);
      if (!runs(j, b, s)) continue;
      const int* L = j.lab + (long long)b * hw;
      const uint8_t* M = j.mask + r * j.W;
      int* out = j.rows + r * j.W;
      line_run_min(
          lane, j.W, bg,
          [&](int x, int& v, bool& fg) {
            fg = M[x] != 0;
            if (fg) v = stencil(j, L, y, x);
          },
          out, 1, [&](int x, int m) { out[x] = m; });
    }
    g.sync();

    // Columns: the run-min of the rows' minima; into the labels.
    const int slot = (s & 1) * j.B;
    for (long long c = warp; c < (long long)j.B * j.W; c += warps) {
      const int b = (int)(c / j.W), x = (int)(c % j.W);
      if (!runs(j, b, s)) continue;
      const long long base = (long long)b * hw + x;
      const uint8_t* M = j.mask + base;
      const int* R = j.rows + base;
      int* L = j.lab + base;
      bool changed = false;
      line_run_min(
          lane, j.H, bg,
          [&](int y, int& v, bool& fg) {
            fg = M[(long long)y * j.W] != 0;
            v = ld(R + (long long)y * j.W);
          },
          j.suffix + base, j.W,
          [&](int y, int m) {
            int* p = L + (long long)y * j.W;
            if (m < ld(p)) {
              changed = true;
              *p = m;
            }
          });
      if (__any_sync(FULL, changed) && lane == 0)
        atomicExch(j.ctrl + slot + b, s + 1);
    }
    g.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) j.ctrl[2 * j.B] = s;
}

}  // namespace

// Labels B (H, W) masks.  `mask` is (B, H, W) bool (one byte a pixel),
// `out` (B, H, W) int32, `work` 2 B H W int32 (the row pass's minima and
// the column pass's suffix minima), `ctrl` 2 B + 1 int32, zero; on return
// ctrl[2 B] holds the sweeps run.  Returns a CUDA error code (0: launched).
extern "C" int mask_components(int B, int H, int W, int connectivity,
                               int max_iters, const void* mask, void* out,
                               void* work, void* ctrl, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)H * W >= (1LL << 31) - 1 ||
      (connectivity != 4 && connectivity != 8) || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  Job j;
  j.mask = (const uint8_t*)mask;
  j.lab = (int*)out;
  j.rows = (int*)work;
  j.suffix = j.rows + (long long)B * H * W;
  j.ctrl = (int*)ctrl;
  j.B = B;
  j.H = H;
  j.W = W;
  j.conn = connectivity;
  j.max_iters = max_iters;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mask_components_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&j};
  err = cudaLaunchCooperativeKernel((const void*)mask_components_kernel,
                                    dim3(per_sm * sms), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
