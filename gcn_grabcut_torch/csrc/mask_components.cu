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
// version moves more, and this kernel reads the labels (a band's rows and
// one more above and below) and writes the rows' minima in the row pass,
// and reads those minima twice and the labels once and writes the labels
// where they fell in the column pass, every sweep (chip_smoke reports its
// sweeps).  Barriers: two a sweep (the first sweep computes the starting
// labels from the mask as it reads them).
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with as many blocks of 256 threads as fit on the
// SMs at once; cooperative_groups' grid sync separates the passes.  In
// every plane a background pixel holds bg = H W, above every foreground
// label, so the planes carry the mask.
//  - Row pass: a block takes a band of R rows (R <= 8, as many as
//    2 R W int32 words of shared memory allow up to 64 KB).  Its threads
//    walk the columns, each label loaded once, and leave the minimum over
//    three rows and the label itself in two shared planes; the stencil is
//    then the minimum of three of the first across (8-connected), or of
//    the first and the label's left and right neighbours (4-connected),
//    once per pixel.  A warp a row takes the run-min there: a backward
//    walk in chunks of 32 leaves each pixel the segmented suffix minimum
//    (warp shuffles; a background pixel ends a run) in place, and the
//    forward walk's segmented prefix minimum of those is the run's
//    minimum, which goes to the rows plane.
//  - Column pass: a block takes 8 adjacent columns of one image, each
//    cut into segments of 8 rows; a warp's lanes read 4 segments x 8
//    columns a row at a time, every 32-byte sector whole.  Each segment's
//    summary per column (the minimum of its top run, of its bottom run,
//    and whether it holds background) goes to shared memory; a warp a
//    column turns them by segmented minimum scans over the segments into
//    the minimum entering each segment from above and from below; then
//    each segment's pixels take their run's minimum within the segment and
//    the carries of a run that reaches its top or bottom, and the labels
//    are written where they fell.  A 1536^2 image at B = 1 is 192 blocks
//    of 8 warps.
// An image that did not change in a sweep is not swept again: each image
// stamps the sweep in which it changed (two slots, read and written in
// alternate sweeps, so no slot is cleared).  Data written in the launch is
// read by ld.global.cg (L2) after a grid barrier, whose fence orders it
// after the writes before the barrier.  The wrapper allocates every buffer;
// the kernel allocates nothing.  With MASK_COMPONENTS_STATS defined, thread
// 0 of the grid also times the row and column passes on the card's
// nanosecond clock (the committed build leaves it out).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BAND = WARPS;          // the row pass's rows a block
constexpr int ROW_SMEM = 64 * 1024;      // what the row pass's band may take
constexpr int COLS = 8;                  // the column pass's columns a block
constexpr int SEG = 8;                   // and its segments' rows
constexpr int MAX_SMEM = 232448;         // a block's shared memory on sm_90
constexpr unsigned HAS_BG = 0x80000000u;

// ctrl's words: 2 B stamps, then the tallies, ending with the sweeps run.
enum { CT_ROW_NS, CT_COL_NS, CT_BARRIERS, CT_SWEEPS, CT_TAIL };

struct Job {
  const uint8_t* mask;   // (B, H, W) bool
  int* lab;              // (B, H, W) labels, the output
  int* rows;             // (B, H, W) the row pass's minima
  int* ctrl;             // 2 B stamps, then CT_TAIL tallies
  int B, H, W, conn, max_iters, band;
};

template <class T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

// Image b runs sweep s if s == 0 or it changed in sweep s - 1, which wrote
// s into slot (s - 1) & 1.
__device__ __forceinline__ bool runs(const Job& j, int b, int s) {
  return s == 0 || ld(j.ctrl + ((s - 1) & 1) * j.B + b) == s;
}

// The card's nanosecond clock with MASK_COMPONENTS_STATS (else 0).
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t = 0;
#ifdef MASK_COMPONENTS_STATS
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}

// Pixel p's label before sweep s (image b's pixel index i): the starting
// labels are computed from the mask.
__device__ __forceinline__ int label(const Job& j, int s, long long p, int i) {
  if (s == 0) return j.mask[p] ? i : j.H * j.W;
  return ld(j.lab + p);
}

// The segmented minimum scan of a warp's 32 values, each lane's (m, f)
// with f set where a run starts (or, for a pixel, where it is background):
// the minimum from the lane back (kDown false: toward lane 0; true: toward
// lane 31) to the nearest start, and whether the span holds one.
template <bool kDown>
__device__ __forceinline__ void seg_scan(int lane, int& m, int& f) {
  for (int d = 1; d < 32; d <<= 1) {
    const int om = kDown ? __shfl_down_sync(FULL, m, d)
                         : __shfl_up_sync(FULL, m, d);
    const int of = kDown ? __shfl_down_sync(FULL, f, d)
                         : __shfl_up_sync(FULL, f, d);
    if ((kDown ? lane + d < 32 : lane >= d) && !f) {
      m = min(m, om);
      f = of;
    }
  }
}

// Row pass of sweep s: every running image's rows, stencil and run-min,
// into j.rows.
__device__ void row_pass(const Job& j, int s, int* sm) {
  const int W = j.W, H = j.H, bg = H * W, R = j.band;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* vert = sm;                        // (R, W) the minimum of 3 rows
  int* own = sm + R * W;                 // (R, W) the labels
  const int bands = (H + R - 1) / R;
  for (long long u = blockIdx.x; u < (long long)j.B * bands; u += gridDim.x) {
    const int b = (int)(u / bands), y0 = (int)(u % bands) * R;
    if (!runs(j, b, s)) continue;
    const long long base = (long long)b * bg;
    __syncthreads();                     // the last band's reads are done
    for (int x = threadIdx.x; x < W; x += THREADS) {
      int above = y0 > 0 ? label(j, s, base + (y0 - 1) * W + x,
                                 (y0 - 1) * W + x)
                         : bg;
      int here = label(j, s, base + y0 * W + x, y0 * W + x);
      for (int r = 0; r < R; ++r) {
        const int y = y0 + r;
        const int below = y + 1 < H ? label(j, s, base + (y + 1) * W + x,
                                            (y + 1) * W + x)
                                    : bg;
        vert[r * W + x] = y < H ? min(min(above, here), below) : bg;
        own[r * W + x] = y < H ? here : bg;
        above = here;
        here = below;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * W; i += THREADS) {
      const int x = i % W;
      if (j.conn == 8) {
        int v = vert[i];
        if (x > 0) v = min(v, vert[i - 1]);
        if (x < W - 1) v = min(v, vert[i + 1]);
        own[i] = own[i] < bg ? v : bg;
      } else {
        int v = vert[i];
        if (x > 0) v = min(v, own[i - 1]);
        if (x < W - 1) v = min(v, own[i + 1]);
        vert[i] = own[i] < bg ? v : bg;
      }
    }
    __syncthreads();
    const int y = y0 + warp;
    if (warp < R && y < H) {
      int* P = (j.conn == 8 ? own : vert) + warp * W;
      const int chunks = (W + 31) / 32;
      int carry = bg;
      for (int c = chunks - 1; c >= 0; --c) {
        const int x = c * 32 + lane;
        int m = x < W ? P[x] : bg;
        int f = m >= bg;
        seg_scan<true>(lane, m, f);
        if (!f) m = min(m, carry);
        carry = __shfl_sync(FULL, m, 0);
        if (x < W) P[x] = m;
      }
      __syncwarp();
      int* out = j.rows + base + (long long)y * W;
      carry = bg;
      for (int c = 0; c < chunks; ++c) {
        const int x = c * 32 + lane;
        int m = x < W ? P[x] : bg;
        int f = m >= bg;
        seg_scan<false>(lane, m, f);
        if (!f) m = min(m, carry);
        carry = __shfl_sync(FULL, m, 31);
        if (x < W) out[x] = m;
      }
    }
  }
}

// Column pass of sweep s: every running image's columns' run-min of the
// rows plane, into the labels; stamps an image that changed.
__device__ void column_pass(const Job& j, int s, int* sm) {
  const int W = j.W, H = j.H, bg = H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = threadIdx.x % COLS, slot = threadIdx.x / COLS;
  const int slots = THREADS / COLS;
  const int segs = (H + SEG - 1) / SEG;
  const int groups = (W + COLS - 1) / COLS;
  unsigned* top = (unsigned*)sm;         // (COLS, segs), then the carries
  int* bot = sm + COLS * segs;           // from below and from above
  for (long long u = blockIdx.x; u < (long long)j.B * groups; u += gridDim.x) {
    const int b = (int)(u / groups), x = (int)(u % groups) * COLS + col;
    if (!runs(j, b, s)) continue;
    const long long base = (long long)b * bg + x;
    for (int g = slot; g < segs; g += slots) {
      unsigned t = bg;
      int lo = bg;
      bool open = true, gap = false;
      for (int r = 0; r < SEG; ++r) {
        const int y = g * SEG + r;
        const int v = x < W && y < H ? ld(j.rows + base + (long long)y * W)
                                     : bg;
        if (v >= bg) {
          open = false;
          gap = true;
        }
        if (open) t = min(t, (unsigned)v);
        lo = v < bg ? min(lo, v) : bg;
      }
      top[col * segs + g] = t | (gap ? HAS_BG : 0u);
      bot[col * segs + g] = lo;
    }
    __syncthreads();
    // A warp a column: the carries from above (a forward scan of the
    // bottom runs) and from below (a backward scan of the top runs).
    if (warp < COLS) {
      unsigned* T = top + warp * segs;
      int* D = bot + warp * segs;
      const int chunks = (segs + 31) / 32;
      int carry = bg;
      for (int c = 0; c < chunks; ++c) {
        const int g = c * 32 + lane;
        int m = g < segs ? D[g] : bg;
        int f = g < segs ? (T[g] & HAS_BG) != 0 : 1;
        seg_scan<false>(lane, m, f);
        if (!f) m = min(m, carry);
        int in = __shfl_up_sync(FULL, m, 1);
        if (lane == 0) in = carry;
        carry = __shfl_sync(FULL, m, 31);
        if (g < segs) D[g] = in;
      }
      __syncwarp();
      carry = bg;
      for (int c = chunks - 1; c >= 0; --c) {
        const int g = c * 32 + lane;
        int m = g < segs ? (int)(T[g] & ~HAS_BG) : bg;
        int f = g < segs ? (T[g] & HAS_BG) != 0 : 1;
        seg_scan<true>(lane, m, f);
        if (!f) m = min(m, carry);
        int in = __shfl_down_sync(FULL, m, 1);
        if (lane == 31) in = carry;
        carry = __shfl_sync(FULL, m, 0);
        if (g < segs) T[g] = (unsigned)in;
      }
    }
    __syncthreads();
    bool changed = false;
    for (int g = slot; g < segs && x < W; g += slots) {
      int v[SEG], pre[SEG];
      int m = bot[col * segs + g];
#pragma unroll
      for (int r = 0; r < SEG; ++r) {
        const int y = g * SEG + r;
        v[r] = y < H ? ld(j.rows + base + (long long)y * W) : bg;
        m = v[r] < bg ? min(m, v[r]) : bg;
        pre[r] = m;
      }
      m = (int)top[col * segs + g];
#pragma unroll
      for (int r = SEG - 1; r >= 0; --r) {
        const int y = g * SEG + r;
        m = v[r] < bg ? min(m, v[r]) : bg;
        if (y >= H) continue;
        const int out = v[r] < bg ? min(pre[r], m) : bg;
        const long long p = base + (long long)y * W;
        const int old = label(j, s, p, y * W + x);
        if (out < old) changed = true;
        if (s == 0 || out < old) j.lab[p] = out;
      }
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicExch(j.ctrl + (s & 1) * j.B + b, s + 1);
  }
}

__global__ void __launch_bounds__(THREADS) mask_components_kernel(Job j) {
  extern __shared__ int sm[];
  cg::grid_group g = cg::this_grid();
  const int hw = j.H * j.W;
  const long long n = (long long)j.B * hw;
  unsigned long long at = clock_ns(), ns[2] = {0, 0};
  int barriers = 0;
  auto barrier = [&](int pass) {
    g.sync();
    if (g.thread_rank() == 0) {
      ++barriers;
      const unsigned long long now = clock_ns();
      ns[pass] += now - at;
      at = now;
    }
  };

  if (j.max_iters == 0)
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
         p += (long long)gridDim.x * THREADS)
      j.lab[p] = j.mask[p] ? (int)(p % hw) : hw;

  int s = 0;
  for (; s < j.max_iters; ++s) {
    bool any = false;
    for (int b = 0; b < j.B && !any; ++b) any = runs(j, b, s);
    if (!any) break;
    row_pass(j, s, sm);
    barrier(0);
    column_pass(j, s, sm);
    barrier(1);
  }
  if (g.thread_rank() == 0) {
    int* tail = j.ctrl + 2 * j.B;
    tail[CT_ROW_NS] = (int)ns[0];
    tail[CT_COL_NS] = (int)ns[1];
    tail[CT_BARRIERS] = barriers;
    tail[CT_SWEEPS] = s;
  }
}

__global__ void __launch_bounds__(THREADS) barrier_loop_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

// The row pass's rows a band for width W, and the dynamic shared memory a
// block takes (the row pass's two planes or the column pass's summaries),
// or 0 if the shape does not fit.
int band_rows(int W) {
  const long long r = ROW_SMEM / (8LL * W);
  return r >= MAX_BAND ? MAX_BAND : (r < 1 ? 1 : (int)r);
}

long long smem_for(int H, int W) {
  const long long rows = 8LL * band_rows(W) * W;
  const long long cols = 8LL * COLS * ((H + SEG - 1) / SEG);
  const long long need = rows > cols ? rows : cols;
  return need <= MAX_SMEM ? need : 0;
}

// The kernel's grid for (H, W): every block resident at once, as many as
// fit.  info (host, 6 ints or null): blocks, resident blocks per SM,
// registers, dynamic shared memory per block, the row pass's band rows,
// the column pass's segment rows.
cudaError_t grid_for(int H, int W, int* blocks, int* info) {
  const int smem = (int)smem_for(H, W);
  if (!smem) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mask_components_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mask_components_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (info) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, mask_components_kernel);
    if (err != cudaSuccess) return err;
    const int v[6] = {*blocks, per_sm, attr.numRegs, smem, band_rows(W), SEG};
    for (int i = 0; i < 6; ++i) info[i] = v[i];
  }
  return cudaSuccess;
}

bool valid_shape(int B, int H, int W) {
  return B >= 1 && H >= 1 && W >= 1 && (long long)H * W < (1LL << 31) - 1 &&
         smem_for(H, W) > 0;
}

}  // namespace

// Labels B (H, W) masks.  `mask` is (B, H, W) bool (one byte a pixel),
// `out` (B, H, W) int32, `work` B H W int32 (the row pass's minima),
// `ctrl` 2 B + 4 int32, zero; on return its last 4 words hold the row and
// column passes' ns (with MASK_COMPONENTS_STATS, else 0), the grid-wide
// barriers and the sweeps run.  W and H must each be at most 29 056 (the
// row pass's band and the column pass's summaries in shared memory).
// Returns a CUDA error code (0: launched).
extern "C" int mask_components(int B, int H, int W, int connectivity,
                               int max_iters, const void* mask, void* out,
                               void* work, void* ctrl, void* stream) {
  if (!valid_shape(B, H, W) || (connectivity != 4 && connectivity != 8) ||
      max_iters < 0)
    return (int)cudaErrorInvalidValue;
  Job j;
  j.mask = (const uint8_t*)mask;
  j.lab = (int*)out;
  j.rows = (int*)work;
  j.ctrl = (int*)ctrl;
  j.B = B;
  j.H = H;
  j.W = W;
  j.conn = connectivity;
  j.max_iters = max_iters;
  j.band = band_rows(W);

  int blocks = 0;
  cudaError_t err = grid_for(H, W, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&j};
  err = cudaLaunchCooperativeKernel((const void*)mask_components_kernel,
                                    dim3(blocks), dim3(THREADS), args,
                                    smem_for(H, W), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's grid for (H, W) (see grid_for); returns a CUDA error code.
extern "C" int mask_components_grid(int H, int W, int* info) {
  if (!valid_shape(1, H, W)) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  return (int)grid_for(H, W, &blocks, info);
}

// `n` empty grid-wide barriers on the kernel's grid for (H, W): its
// barrier floor.
extern "C" int mask_components_barriers(int H, int W, int n, void* stream) {
  if (!valid_shape(1, H, W) || n < 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_for(H, W, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
