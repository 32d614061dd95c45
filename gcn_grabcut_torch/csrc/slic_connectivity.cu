// SLIC's connectivity repair for a batch of label maps on Hopper (sm_90a):
// the port's repair_connectivity (ops/slic.py: _absorb_orphans, then
// enforce_connectivity) on the card, every loop and every image's
// convergence tests in one launch.
//
// Replaces no Pallas kernel.  In the JAX package the repair is XLA code
// (gcn_grabcut_tpu/ops/slic.py): _absorb_orphans, a fori_loop of four
// checkerboard sweeps, and enforce_connectivity, whose two lax.while_loops
// (the components and the absorption of minor fragments) test convergence
// on the device; the build vmaps them over the batch.  Eager PyTorch turns
// the loops into Python loops of small kernels with a host sync per block
// (ops/slic.py enforce_connectivity_plain).  This kernel keeps the loops
// and their tests on the card.
//
// What it computes: the plain versions' labels, bit for bit, for B
// same-size (H, W) int32 label maps in [0, k).
//   0. absorb_sweeps sweeps of orphan absorption, each a half-sweep of the
//      pixels with (y + x) even, then of those with it odd: a pixel none of
//      whose 4-neighbours (edge-replicated) shares its label takes the
//      label most frequent among them, the first of up, down, left, right
//      on a tie.  A half-sweep writes one parity and reads the other, so
//      in place it is the plain version's Jacobi half-sweep.
//   Then, when max_sweeps > 0 (enforce_connectivity):
//   1. components: comp = the linear index y W + x, then blocks of 4
//      Jacobi steps, comp(p) = min(comp(p), comp(q) over the 4-neighbours q
//      with p's label), until a block changes nothing in the image or
//      max_sweeps blocks are done;
//   2. each component's size, and the score size H W - comp in float32,
//      the multiply and the subtract each rounded (__fmul_rn, __fsub_rn:
//      nvcc would contract them into an FMA, which rounds once and can
//      break the ties the score decides);
//   3. each label's best score (an integer atomicMax on the float's
//      ordered bits: the same maximum in any order), and minor = score <
//      its label's best;
//   4. absorption rounds, each four phases of parity 0, 1, 0, 1: a minor
//      pixel of the phase's parity takes the label of its first neighbour
//      (up, down, left, right; in the image) that is not minor, and is no
//      longer minor; until a round moves no pixel of the image or
//      max_sweeps rounds are done.
// Each image stops each loop on its own.  An image whose block or round
// changed nothing is at its fixpoint, where the plain version's further
// steps (its lock step runs until every image stops) change nothing; at
// the caps both have done the same Jacobi steps.
//
// Bound.  Bytes: the labels read once and written once, 8 bytes a pixel,
// over 3.35 TB/s on an H100.  This design moves more: a component block
// reads a 40 x 40 window of labels and components for a 32 x 32 tile and
// writes the tile, each sweep and round reads the image's labels again.
// Barriers: one after the set-up, one a half-sweep, one a component block,
// three for sizes, scores and flags, and four a round.
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with as many blocks of 256 threads as fit on the
// SMs at once; cooperative_groups' grid sync separates the passes.  A
// component block is one pass over 32 x 32 tiles: a block loads a tile of
// one image with a halo of 4 pixels (labels and components) into shared
// memory, runs the 4 Jacobi steps there, each on a window one pixel
// smaller on every side, and writes the interior, which the halo makes
// exact, into the other of two component planes; out of the image nothing
// moves and a component reads H W.  An image whose block changed nothing is
// not processed again: each image stamps the block (and the round) in
// which it changed, in two slots read and written in alternate blocks, so
// no slot is cleared.  The sweeps of 0. and the phases of 4. are
// grid-strided passes over the pixels, in place.  Data written in the
// launch is read by ld.global.cg (L2) after a grid barrier, whose fence
// orders it after the writes before the barrier.  The wrapper allocates
// every buffer; the kernel allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;                 // a component tile's interior
constexpr int STEPS = 4;                 // Jacobi steps a block
constexpr int WIN = TILE + 2 * STEPS;    // its window, halo included
constexpr int WIN2 = WIN * WIN;

struct Job {
  const int* in;         // (B, H, W) labels in
  int* lab;              // (B, H, W) labels out, updated in place
  int* comp[2];          // (B, H, W) component planes
  int* size;             // (B, H W) component sizes
  unsigned* best;        // (B, k) each label's best score, ordered bits
  uint8_t* minor;        // (B, H, W)
  int* ctrl;             // 2 B block stamps, 2 B round stamps, then the
                         // blocks and the rounds run
  int B, H, W, k, absorb_sweeps, max_sweeps;
};

template <class T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

// Image b runs step s of a loop if s == 0 or it changed in step s - 1,
// which wrote s into slot (s - 1) & 1 of the loop's stamps.
__device__ __forceinline__ bool runs(const int* stamps, int B, int b, int s) {
  return s == 0 || ld(stamps + ((s - 1) & 1) * B + b) == s;
}

__device__ __forceinline__ bool any_runs(const int* stamps, int B, int s) {
  for (int b = 0; b < B; ++b)
    if (runs(stamps, B, b, s)) return true;
  return false;
}

// The float's bits in an order that an unsigned max keeps.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// size H W - comp, each operation rounded on its own.
__device__ __forceinline__ float score(int size, int hw, int comp) {
  return __fsub_rn(__fmul_rn((float)size, (float)hw), (float)comp);
}

// One orphan half-sweep of the pixels of `parity`, in place.
__device__ void orphan_half_sweep(const Job& j, int parity) {
  const long long n = (long long)j.B * j.H * j.W;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS) {
    const int x = (int)(p % j.W), y = (int)((p / j.W) % j.H);
    if (((y + x) & 1) != parity) continue;
    const int c = ld(j.lab + p);
    const int nb[4] = {y > 0 ? ld(j.lab + p - j.W) : c,
                       y < j.H - 1 ? ld(j.lab + p + j.W) : c,
                       x > 0 ? ld(j.lab + p - 1) : c,
                       x < j.W - 1 ? ld(j.lab + p + 1) : c};
    if (nb[0] == c || nb[1] == c || nb[2] == c || nb[3] == c) continue;
    int best = nb[0], best_n = 0;
    for (int i = 0; i < 4; ++i) {
      int cnt = 0;
      for (int q = 0; q < 4; ++q) cnt += nb[q] == nb[i];
      if (i == 0 || cnt > best_n) {
        best = nb[i];
        best_n = cnt;
      }
    }
    j.lab[p] = best;
  }
}

// One block of STEPS Jacobi steps of image tiles, comp[cur] -> comp[!cur];
// stamps an image that changed.
__device__ void component_block(const Job& j, int s, int* stamps) {
  __shared__ int lab_s[WIN2];
  __shared__ int c_s[3][WIN2];           // the loaded window, then two steps
  const int cur = s & 1;
  const int ty_n = (j.H + TILE - 1) / TILE, tx_n = (j.W + TILE - 1) / TILE;
  const long long tiles = (long long)j.B * ty_n * tx_n;
  const int hw = j.H * j.W;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = (int)(t / (ty_n * tx_n));
    if (!runs(stamps, j.B, b, s)) continue;
    const int tr = (int)(t % (ty_n * tx_n));
    const int y0 = (tr / tx_n) * TILE - STEPS, x0 = (tr % tx_n) * TILE - STEPS;
    const int* L = j.lab + (long long)b * hw;
    const int* C = j.comp[cur] + (long long)b * hw;
    for (int i = threadIdx.x; i < WIN2; i += THREADS) {
      const int y = y0 + i / WIN, x = x0 + i % WIN;
      const bool in = y >= 0 && y < j.H && x >= 0 && x < j.W;
      lab_s[i] = in ? ld(L + y * j.W + x) : -1;
      c_s[0][i] = in ? ld(C + y * j.W + x) : hw;
    }
    __syncthreads();
    int from = 0;
    for (int step = 1; step <= STEPS; ++step) {
      const int to = step == 1 ? 1 : 3 - from;
      for (int i = threadIdx.x; i < WIN2; i += THREADS) {
        const int wy = i / WIN, wx = i % WIN;
        const int y = y0 + wy, x = x0 + wx;
        int v = c_s[from][i];
        if (wy >= step && wy < WIN - step && wx >= step && wx < WIN - step &&
            y >= 0 && y < j.H && x >= 0 && x < j.W) {
          const int l = lab_s[i];
          if (lab_s[i - WIN] == l) v = min(v, c_s[from][i - WIN]);
          if (lab_s[i + WIN] == l) v = min(v, c_s[from][i + WIN]);
          if (lab_s[i - 1] == l) v = min(v, c_s[from][i - 1]);
          if (lab_s[i + 1] == l) v = min(v, c_s[from][i + 1]);
        }
        c_s[to][i] = v;
      }
      __syncthreads();
      from = to;
    }
    int* out = j.comp[cur ^ 1] + (long long)b * hw;
    bool changed = false;
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
      const int wy = STEPS + i / TILE, wx = STEPS + i % TILE;
      const int y = y0 + wy, x = x0 + wx;
      if (y >= j.H || x >= j.W) continue;
      const int w = wy * WIN + wx;
      out[y * j.W + x] = c_s[from][w];
      changed |= c_s[from][w] < c_s[0][w];
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0)
      atomicExch(stamps + cur * j.B + b, s + 1);
  }
}

// One absorption phase of the pixels of `parity`, in place; stamps an
// image that moved a pixel.
__device__ void absorb_phase(const Job& j, int parity, int r, int* stamps) {
  const int hw = j.H * j.W;
  const long long n = (long long)j.B * hw;
  for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < n;
       p += (long long)gridDim.x * THREADS) {
    const int b = (int)(p / hw);
    const int x = (int)(p % j.W), y = (int)((p / j.W) % j.H);
    if (((y + x) & 1) != parity || !runs(stamps, j.B, b, r) ||
        !ld(j.minor + p))
      continue;
    long long q = -1;
    if (y > 0 && !ld(j.minor + p - j.W)) q = p - j.W;
    else if (y < j.H - 1 && !ld(j.minor + p + j.W)) q = p + j.W;
    else if (x > 0 && !ld(j.minor + p - 1)) q = p - 1;
    else if (x < j.W - 1 && !ld(j.minor + p + 1)) q = p + 1;
    if (q < 0) continue;
    j.lab[p] = ld(j.lab + q);
    j.minor[p] = 0;
    // Once the stamp shows, the image's other moves need no atomic.
    int* stamp = stamps + (r & 1) * j.B + b;
    if (ld(stamp) != r + 1) atomicExch(stamp, r + 1);
  }
}

__global__ void __launch_bounds__(THREADS) slic_connectivity_kernel(Job j) {
  cg::grid_group g = cg::this_grid();
  const int hw = j.H * j.W;
  const long long n = (long long)j.B * hw;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const bool enforce = j.max_sweeps > 0;
  int* block_stamps = j.ctrl;
  int* round_stamps = j.ctrl + 2 * j.B;

  for (long long p = tid; p < n; p += stride) {
    j.lab[p] = j.in[p];
    if (enforce) {
      j.comp[0][p] = (int)(p % hw);
      j.size[p] = 0;
    }
  }
  if (enforce)
    for (long long i = tid; i < (long long)j.B * j.k; i += stride)
      j.best[i] = 0u;   // below the ordered bits of every score
  g.sync();

  for (int sw = 0; sw < j.absorb_sweeps; ++sw)
    for (int parity = 0; parity < 2; ++parity) {
      orphan_half_sweep(j, parity);
      g.sync();
    }
  if (!enforce) return;

  int s = 0;
  for (; s < j.max_sweeps && any_runs(block_stamps, j.B, s); ++s) {
    component_block(j, s, block_stamps);
    g.sync();
  }
  const int* comp = j.comp[s & 1];

  for (long long p = tid; p < n; p += stride)
    atomicAdd(j.size + (p / hw) * hw + ld(comp + p), 1);
  g.sync();
  for (long long p = tid; p < n; p += stride) {
    const long long base = (p / hw) * hw;
    const int c = ld(comp + p);
    const int l = ld(j.lab + p);
    if (l >= 0 && l < j.k)
      atomicMax(j.best + (p / hw) * j.k + l,
                ordered(score(ld(j.size + base + c), hw, c)));
  }
  g.sync();
  for (long long p = tid; p < n; p += stride) {
    const long long base = (p / hw) * hw;
    const int c = ld(comp + p);
    const int l = ld(j.lab + p);
    j.minor[p] = l >= 0 && l < j.k &&
                 ordered(score(ld(j.size + base + c), hw, c)) <
                     ld(j.best + (p / hw) * j.k + l);
  }
  g.sync();

  int r = 0;
  for (; r < j.max_sweeps && any_runs(round_stamps, j.B, r); ++r)
    for (int phase = 0; phase < 4; ++phase) {
      absorb_phase(j, phase & 1, r, round_stamps);
      g.sync();
    }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    j.ctrl[4 * j.B] = s;
    j.ctrl[4 * j.B + 1] = r;
  }
}

}  // namespace

// Repairs B (H, W) label maps.  `in` and `out` are (B, H, W) int32, labels
// in [0, k) (a label outside it never counts as a label's best, and is not
// minor); `work` holds 3 B H W + B k int32 words (two component planes,
// the sizes, the best scores), then B H W bytes (the minor flags); `ctrl`
// 4 B + 2 int32, zero; on return ctrl[4 B] and ctrl[4 B + 1] hold the
// component blocks and absorption rounds run.  absorb_sweeps orphan sweeps
// come first; max_sweeps 0 skips enforce_connectivity (and k is not read).
// Returns a CUDA error code (0: launched).
extern "C" int slic_connectivity(int B, int H, int W, int k,
                                 int absorb_sweeps, int max_sweeps,
                                 const void* in, void* out, void* work,
                                 void* ctrl, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)H * W >= (1LL << 24) || k < 1 ||
      absorb_sweeps < 0 || max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  Job j;
  j.in = (const int*)in;
  j.lab = (int*)out;
  j.comp[0] = (int*)work;
  j.comp[1] = j.comp[0] + n;
  j.size = j.comp[1] + n;
  j.best = (unsigned*)(j.size + n);
  j.minor = (uint8_t*)(j.best + (long long)B * k);
  j.ctrl = (int*)ctrl;
  j.B = B;
  j.H = H;
  j.W = W;
  j.k = k;
  j.absorb_sweeps = absorb_sweeps;
  j.max_sweeps = max_sweeps;

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slic_connectivity_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&j};
  err = cudaLaunchCooperativeKernel((const void*)slic_connectivity_kernel,
                                    dim3(per_sm * sms), dim3(THREADS), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
