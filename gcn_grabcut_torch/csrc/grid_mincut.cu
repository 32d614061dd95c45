// Push-relabel min-cut on a batch of pixel lattices for Hopper (sm_90a): the
// port's device solver (ops/maxflow.py grid_mincut_batch) on the card, the
// whole solve in one launch.
//
// Replaces no Pallas kernel.  In the JAX package the solve is XLA code
// (gcn_grabcut_tpu/ops/maxflow.py _build_solver): three lax.while_loops
// (the global relabel's relaxation, the outer rounds, the push sweeps as a
// fori_loop) whose convergence tests run on the device, with no host round
// trip inside a solve.  Eager PyTorch turns those loops into Python loops
// of small stencil kernels (~140 launches a push sweep, 17 a relabel step)
// and a host sync per relabel block and per round.  This kernel keeps the
// loops and their tests on the card, as XLA's while loops do.
//
// What it computes: what the plain version (ops/maxflow.py
// grid_mincut_plain) computes, bit for bit, for B same-size lattices in
// lock step (JAX's vmap of the solve).  Inputs, updated in place: the
// excess e and the residual planes r_fwd[d], r_bwd[d] (float32, (B, H, W),
// one pair per direction of OFFSETS_4 / OFFSETS_8).  Outputs: fg (h >= INF
// after the final relabel), e', r_fwd', r_bwd', each image's outer rounds
// and the batch's relabel steps.
//
//   relabel every image
//   for r = 1 .. max_outer:
//     an image is live in round r if it was live in r - 1 and still has an
//       active pixel (e > 1e-6f and h < INF); a converged image is frozen:
//       neither swept nor relabelled again until the final relabel
//     no live image: stop
//     relabel the live images, then n_sweeps push sweeps on them
//   relabel every image; fg = h >= INF
//
// The relabel relaxes in blocks of `unroll` min-plus steps from h = (e < 0
// ? 0 : INF), testing only the last step of a block, until that step
// changes no height of the set or relabel_iters steps are done.  An image
// whose block's last step changed none of its heights is at its fixpoint
// and is not relaxed again in this relabel; the batch goes on while one of
// its images changes, so its steps are the plain version's, whose lock
// step relaxes every image until the last one stops (the same heights: a
// fixpoint does not move).  A push sweep runs each direction's forward
// push (p -> p + off) and then its backward push (p -> p - off along the
// neighbour's r_bwd), each reading the state its predecessor left, then
// lifts the overflowing pixels: the plain version's order.  Each directed
// push does its float32 operations in the plain version's order: f = can ?
// min(e, r) : +0, r_fwd - f and r_bwd + f, (e - f) + f_shifted.  Adds of +0
// are done too (-0 + +0 is +0), and there is no multiply to contract: the
// build has no --use_fast_math.  Out of the image a height reads INF and a
// residual, excess or flow 0, the plain version's padding.
//
// Bound.  Bytes: what the solve must move whatever the design, over 3.35
// TB/s on an H100, counted on the data by a run of the plain version
// (chip_smoke.mincut_work and mincut_bytes): a push sweep reads e and the
// height of every pixel, 8 bytes, which decides whether its window can
// push or lift, and reads and writes e, the height and both residual
// planes of each of D directions, 16 + 16 D bytes, only where the window
// can; a relax block, whose last step alone the solve tests, reads heights
// and arcs and writes heights, 9, only where a height within its steps'
// reach moved in the block before.  This design moves more: a tile reads
// its halo as well (a push sweep's 32 x 32 tile reads a 38 x 38 window at
// D = 4, its heights 40 x 40; a relax sub-block's 32 x 32 tile a window 2
// k wider each way), a tile moves all its pixels or none, and a stopped
// image's heights are copied once.  Barriers: one
// grid barrier a push sweep, one a relax sub-block of at most RELAX_HALO
// steps, one a relabel's set-up and one a round test; a solve cannot take
// less than their sum times an empty barrier (chip_smoke times an empty
// barrier loop on the same grid).
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with as many blocks as fit on the SMs at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the dynamic shared
// memory attribute is set); each block walks (image, tile) pairs, and
// cooperative_groups' grid sync separates dependent passes.
// - A push sweep is one pass: a block loads a tile of one image with its
//   halo (sweep_halo: pixels of e and the residual planes that the tile's
//   interior depends on, heights one pixel further) into shared memory by
//   cp.async, every load of the tile in flight at once, runs the 2 D + 2
//   push passes and the lift there with __syncthreads() between them (the
//   flows to neighbours in two shared arrays, so no pass reads what
//   another thread of it writes), and writes back only the interior.  Halo
//   pixels repeat their neighbours' work, so the interior is exact.  Tiles
//   read the halo that neighbouring tiles write, so e and the residual
//   planes are double-buffered across sweeps (the caller's set and a
//   second one), as the heights are; every live image sweeps together, so
//   they share one parity, and a frozen image's is (its rounds x n_sweeps)
//   mod 2: the final relabel's set-up reads each image from its set and
//   copies an odd one back into the caller's.
// - A quiet window (no pixel with e > 0 and h < INF) can neither push nor
//   lift: its sweep adds +0 to every value (turning -0 into +0) and keeps
//   the heights, and the tile writes just that.  Every value a sweep
//   writes is then free of -0, so after a quiet sweep past the first both
//   state sets hold the tile's bits.  A tile whose window and its 8
//   neighbours' were quiet in the round's previous sweep has an unchanged,
//   quiet window, and the set this sweep would write already holds what it
//   would write: it is skipped, touching no memory (a flag per tile and
//   parity records quiet windows).  A relabel changes heights, so the
//   first sweep of a round skips nothing.
// - A relax sub-block of k <= RELAX_HALO steps loads a tile's heights and
//   arc bits with a halo of k, runs the k min-plus steps in shared memory
//   (two height arrays) and writes back the interior, testing the interior
//   alone; a block of `unroll` steps is ceil(unroll / RELAX_HALO)
//   sub-blocks.  A sub-block is a function of its window, so a tile none
//   of whose window's heights moved in the last sub-block (no height of
//   its own or its 8 neighbours' interiors lowered) would write what both
//   height buffers hold: it is skipped (a flag per tile and parity).  Each
//   image keeps a relax stamp: the block number of its last block that
//   changed a height.  An image relaxes in block j if its stamp is j - 1;
//   one whose stamp is j - 2 stopped in block j - 1, and its heights are
//   copied into the other buffer once, in block j, so that every image
//   ends in the same one.
// Hazards: every thread takes each branch from values written before the
// barrier it has just passed -- stamps only grow, so a later one seen early
// decides the same; the round test stores the round number per image
// (`act`, which ends as each image's round count); a tile's flags are read
// a phase after they are written.  In-launch data is read by ld.global.cg
// (L2) or by cp.async after a grid barrier, whose fence orders it after
// the writes before the barrier.  The wrapper allocates every buffer; the
// kernel allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIRS = 4;
// A push sweep's tile and a relax sub-block's: rows x columns of interior.
constexpr int TILE_H = 32, TILE_W = 32;
constexpr int RELAX_H = 32, RELAX_W = 32;
// The most min-plus steps a relax sub-block runs: its largest halo.
constexpr int RELAX_HALO = 4;
// ctrl: relabel steps, barriers, relabel image-steps, stopped images'
// height copies, sweep tiles swept (not skipped), relax tiles relaxed; with
// GRID_MINCUT_STATS defined also quiet sweep tiles swept, relax tiles
// skipped, the microseconds of the push sweeps and of the relabels (else
// 0); then one round number per image, then one relax stamp per image.
constexpr int CTRL_STEPS = 0, CTRL_BARRIERS = 1, CTRL_IMAGE_STEPS = 2,
              CTRL_COPIES = 3, CTRL_SWEPT = 4, CTRL_RELAXED = 5,
              CTRL_QUIET = 6, CTRL_RELAX_SKIPPED = 7, CTRL_SWEEP_US = 8,
              CTRL_RELABEL_US = 9, CTRL_ACT = 10;

// OFFSETS_8 = (0, -1), (-1, 0), (-1, -1), (-1, 1); OFFSETS_4 its first two.
__host__ __device__ constexpr int dir_y(int d) { return d == 0 ? 0 : -1; }
__host__ __device__ constexpr int dir_x(int d) {
  return d == 0 ? -1 : (d == 1 ? 0 : (d == 2 ? -1 : 1));
}

// ops/maxflow.py sweep_halo: the directions moving along an axis, the
// larger over the two axes (3 at D = 4, 1 at D = 2).
constexpr int sweep_halo(int nd) {
  int ay = 0, ax = 0;
  for (int d = 0; d < nd; ++d) {
    ay += dir_y(d) != 0;
    ax += dir_x(d) != 0;
  }
  return ay > ax ? ay : ax;
}

// Shared-memory layout of a push sweep's tile and a relax sub-block's.
template <int ND>
struct Tiles {
  static constexpr int HALO = sweep_halo(ND);
  // The state window (e, the residual planes, two flows) and the heights'.
  static constexpr int WH = TILE_H + 2 * HALO, WW = TILE_W + 2 * HALO;
  static constexpr int NW = WH * WW;
  static constexpr int HW = WW + 2, NH = (WH + 2) * HW;
  static constexpr int SWEEP_BYTES = (3 + 2 * ND) * NW * 4 + NH * 4;
  static constexpr int NR = (RELAX_H + 2 * RELAX_HALO) *
                            (RELAX_W + 2 * RELAX_HALO);
  static constexpr int RELAX_BYTES = 2 * NR * 4 + NR;
  static constexpr int SMEM =
      SWEEP_BYTES > RELAX_BYTES ? SWEEP_BYTES : RELAX_BYTES;
};

struct Solve {
  float* e[2];                 // the caller's set, then the second
  float* rf[2][MAX_DIRS];
  float* rb[2][MAX_DIRS];
  int* h[2];
  uint8_t* arcs;   // the relabel's usable arcs: bit 2d forward, 2d+1 back
  uint8_t* quiet[2];   // per (image, sweep tile): quiet in the last sweep
                       // of this parity, its two state sets equal
  uint8_t* lowered[2];   // per (image, relax tile): a height lowered in the
                         // last relax sub-block of this parity
  uint8_t* fg;
  int* ctrl;
  int B, H, W, inf;
  int max_outer, n_sweeps, relabel_iters, unroll;
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void st_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// One 4-byte word from global to shared memory without a register: every
// load of a tile is in flight at once, waited for by cp_async_wait.
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool inside(const Solve& s, int y, int x) {
  return y >= 0 && y < s.H && x >= 0 && x < s.W;
}

__device__ __forceinline__ int* stamp_of(const Solve& s, int b) {
  return s.ctrl + CTRL_ACT + s.B + b;
}

// Each image's round number and relax stamp as the block last read them,
// img[b] and img[B + b] in shared memory after the tiles': read again after
// a grid barrier past which they may have changed, all in parallel.
__device__ __forceinline__ void refresh(const Solve& s, int* img) {
  for (int b = threadIdx.x; b < s.B; b += THREADS) {
    img[b] = ld_volatile(s.ctrl + CTRL_ACT + b);
    img[s.B + b] = ld_volatile(stamp_of(s, b));
  }
  __syncthreads();
}

// In the set of a relabel or sweep of round `lo` (lo < 0: every image).
__device__ __forceinline__ bool in_set(const int* img, int lo, int b) {
  return lo < 0 || img[b] >= lo;
}

// Calls body(b, i, y, x) for every pixel of every image b for which take(b)
// holds, grid-stride within each image.
template <class Take, class Body>
__device__ __forceinline__ void each_pixel(const Solve& s, Take take,
                                           Body body) {
  const int hw = s.H * s.W;
  const int stride = gridDim.x * blockDim.x;
  for (int b = 0; b < s.B; ++b) {
    if (!take(b)) continue;
    const long long base = (long long)b * hw;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw; p += stride) {
      const int y = p / s.W;
      body(b, base + p, y, p - y * s.W);
    }
  }
}

// Calls tile(b, y0, x0) for this block's share of the th x tw tiles of
// every image b for which take(b) holds (the same answer in every thread):
// the (image, tile) pairs in order, dealt round the grid.
template <class Take, class Tile>
__device__ __forceinline__ void each_tile(const Solve& s, int th, int tw,
                                          Take take, Tile tile) {
  const int nx = (s.W + tw - 1) / tw;
  const int per = (s.H + th - 1) / th * nx;
  int t = blockIdx.x;
  for (int b = 0; b < s.B; ++b) {
    if (!take(b)) continue;
    for (; t < per; t += gridDim.x) tile(b, t / nx * th, t % nx * tw);
    t -= per;
  }
}

// Tallies kept by thread 0 of the grid (the steps, barriers, image-steps,
// copies and times) and by thread 0 of each block (its tiles), written to
// ctrl at the end.
struct Tally {
  int steps = 0, barriers = 0, image_steps = 0, copies = 0;
  int swept = 0, relaxed = 0, quiet = 0, relax_skipped = 0;
  unsigned long long sweep_ns = 0, relabel_ns = 0;
};

// The card's nanosecond clock with GRID_MINCUT_STATS (else 0): every phase
// ends in a grid barrier, so thread 0's readings around a phase time the
// whole grid's.
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t = 0;
#ifdef GRID_MINCUT_STATS
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}

// Adds one to a tally kept only with GRID_MINCUT_STATS.
__device__ __forceinline__ void stat(int& n) {
#ifdef GRID_MINCUT_STATS
  ++n;
#else
  (void)n;
#endif
}

__device__ __forceinline__ void barrier(cg::grid_group& g, Tally& t) {
  ++t.barriers;
  g.sync();
}

// A push sweep's window in shared memory: e, the residual planes of each
// direction, the two flows and the heights (one pixel wider).
template <int ND>
struct Window {
  using T = Tiles<ND>;
  float *E, *RF, *RB, *FF, *FB;   // RF + d NW: direction d; FF the forward
  int* Hs;                        // flow p -> p + off, FB the backward one
  __device__ explicit Window(unsigned char* sm) {
    E = reinterpret_cast<float*>(sm);
    RF = E + T::NW;
    RB = RF + ND * T::NW;
    FF = RB + ND * T::NW;
    FB = FF + T::NW;
    Hs = reinterpret_cast<int*>(FB + T::NW);
  }
};

// Starts the loads of the window of the tile at (y0, x0) of the image at
// `base` (state from set sp, heights from h) by cp.async, and stores the
// out-of-image fill; the caller waits for the loads and syncs the block.
template <int ND>
__device__ void load_window(const Solve& s, int sp, const int* h,
                            long long base, int y0, int x0, Window<ND> w) {
  using T = Tiles<ND>;
  constexpr int R = T::HALO, WW = T::WW, NW = T::NW;
  constexpr int HW = T::HW, NH = T::NH;
  float *E = w.E, *RF = w.RF, *RB = w.RB;
  int* Hs = w.Hs;
  const int W = s.W, inf = s.inf;
  const int wy0 = y0 - R, wx0 = x0 - R;
  for (int i = threadIdx.x; i < NW; i += THREADS) {
    const int wy = i / WW, wx = i - wy * WW;
    const int y = wy0 + wy, x = wx0 + wx;
    const long long g = base + (long long)y * W + x;
    if (inside(s, y, x)) {
      cp_async(E + i, s.e[sp] + g);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        cp_async(RF + d * NW + i, s.rf[sp][d] + g);
        cp_async(RB + d * NW + i, s.rb[sp][d] + g);
      }
    } else {
      E[i] = 0.0f;
#pragma unroll
      for (int d = 0; d < ND; ++d) RF[d * NW + i] = RB[d * NW + i] = 0.0f;
    }
  }
  for (int i = threadIdx.x; i < NH; i += THREADS) {
    const int wy = i / HW, wx = i - wy * HW;
    const int y = wy0 - 1 + wy, x = wx0 - 1 + wx;
    if (inside(s, y, x))
      cp_async(Hs + i, h + base + (long long)y * W + x);
    else
      Hs[i] = inf;
  }
}

// One push sweep of the tile at (y0, x0) of the image at `base` on its
// loaded window: the interior's state into set sp ^ 1, its lifted heights
// into hn.  Every thread of the block calls it; returns, in every thread,
// whether the window was quiet (no pixel with e > 0 and h < INF).
template <int ND>
__device__ bool sweep_window(const Solve& s, int sp, int* hn, long long base,
                             int y0, int x0, Window<ND> w) {
  using T = Tiles<ND>;
  constexpr int R = T::HALO, WH = T::WH, WW = T::WW, NW = T::NW;
  constexpr int HW = T::HW;
  float *E = w.E, *RF = w.RF, *RB = w.RB, *FF = w.FF, *FB = w.FB;
  const int* Hs = w.Hs;
  const int H = s.H, W = s.W, inf = s.inf;
  auto win = [](int wy, int wx) {
    return wy >= 0 && wy < WH && wx >= 0 && wx < WW;
  };
  const int sn = sp ^ 1;
  bool active = false;
  for (int i = threadIdx.x; i < NW; i += THREADS)
    active |= E[i] > 0.0f && Hs[i + 2 * (i / WW) + HW + 1] < inf;
  if (!__syncthreads_or(active)) {
    // A quiet window: no pixel can push or lift, so every push adds +0 to
    // e and the residuals (turning -0 into +0) and the heights stay.
    for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
      const int ty = i / TILE_W, tx = i - ty * TILE_W;
      const int y = y0 + ty, x = x0 + tx;
      if (y >= H || x >= W) continue;
      const int wi = (ty + R) * WW + tx + R;
      const long long g = base + (long long)y * W + x;
      const float ev = E[wi] + 0.0f;
      hn[g] = ev < 0.0f ? 0 : Hs[(ty + R + 1) * HW + tx + R + 1];
      s.e[sn][g] = ev;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        s.rf[sn][d][g] = RF[d * NW + wi] + 0.0f;
        s.rb[sn][d][g] = RB[d * NW + wi] + 0.0f;
      }
    }
    __syncthreads();
    return true;
  }
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int dy = dir_y(d), dx = dir_x(d);
    const int o = dy * WW + dx, oh = dy * HW + dx;
    // p receives the previous direction's backward flow from p + off', then
    // pushes p -> p + off along r_fwd.
    for (int i = threadIdx.x; i < NW; i += THREADS) {
      const int wy = i / WW, wx = i - wy * WW, hi = i + 2 * wy + HW + 1;
      float ev = E[i];
      if (d > 0) {
        const int py = dir_y(d - 1), px = dir_x(d - 1);
        const float back =
            win(wy + py, wx + px) ? FB[i + py * WW + px] : 0.0f;
        RB[(d - 1) * NW + i] = RB[(d - 1) * NW + i] - back;
        RF[(d - 1) * NW + i] = RF[(d - 1) * NW + i] + back;
        ev = ev + back;
      }
      const int hp = Hs[hi], hq = Hs[hi + oh];
      const float res = RF[d * NW + i];
      const bool can = ev > 0.0f && hp < inf && hp == hq + 1 && res > 0.0f;
      const float f = can ? fminf(ev, res) : 0.0f;
      RF[d * NW + i] = res - f;
      RB[d * NW + i] = RB[d * NW + i] + f;
      E[i] = ev - f;
      FF[i] = f;
    }
    __syncthreads();
    // p receives the forward flow from p - off, then pushes p -> p - off
    // along the neighbour's r_bwd.
    for (int i = threadIdx.x; i < NW; i += THREADS) {
      const int wy = i / WW, wx = i - wy * WW, hi = i + 2 * wy + HW + 1;
      const bool nb = win(wy - dy, wx - dx);
      const float ev = E[i] + (nb ? FF[i - o] : 0.0f);
      const int hp = Hs[hi], hq = Hs[hi - oh];
      const float res = nb ? RB[d * NW + i - o] : 0.0f;
      const bool can = ev > 0.0f && hp < inf && hp == hq + 1 && res > 0.0f;
      const float f = can ? fminf(ev, res) : 0.0f;
      E[i] = ev - f;
      FB[i] = f;
    }
    __syncthreads();
  }
  {
    // The last direction's backward flow arrives at p - off from p.
    constexpr int dy = dir_y(ND - 1), dx = dir_x(ND - 1);
    for (int i = threadIdx.x; i < NW; i += THREADS) {
      const int wy = i / WW, wx = i - wy * WW;
      const float back =
          win(wy + dy, wx + dx) ? FB[i + dy * WW + dx] : 0.0f;
      RB[(ND - 1) * NW + i] = RB[(ND - 1) * NW + i] - back;
      RF[(ND - 1) * NW + i] = RF[(ND - 1) * NW + i] + back;
      E[i] = E[i] + back;
    }
  }
  __syncthreads();
  // Lift the interior's overflowing pixels to 1 + the lowest reachable
  // neighbour, and write the interior back.
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
    const int ty = i / TILE_W, tx = i - ty * TILE_W;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const int wi = (ty + R) * WW + tx + R;
    const int hi = (ty + R + 1) * HW + tx + R + 1;
    const int hp = Hs[hi];
    int nh = inf;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int dy = dir_y(d), dx = dir_x(d);
      const int o = dy * WW + dx, oh = dy * HW + dx;
      if (RF[d * NW + wi] > 0.0f) nh = min(nh, Hs[hi + oh] + 1);
      if (RB[d * NW + wi - o] > 0.0f) nh = min(nh, Hs[hi - oh] + 1);
    }
    const float ev = E[wi];
    const int lifted = ev > 0.0f && hp < inf ? max(hp, nh) : hp;
    const long long g = base + (long long)y * W + x;
    hn[g] = ev < 0.0f ? 0 : lifted;
    s.e[sn][g] = ev;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      s.rf[sn][d][g] = RF[d * NW + wi];
      s.rb[sn][d][g] = RB[d * NW + wi];
    }
  }
  __syncthreads();
  return false;
}

// Flags of relax_tile: the last step lowered an interior height; some
// step did.
constexpr int LAST_LOWERED = 1, LOWERED = 2;

// K min-plus steps of the relax on the tile at (y0, x0) of the image at
// `base`, heights from src, the interior's into dst.  Returns, in every
// thread of the block, LAST_LOWERED (when `test`) and LOWERED.
template <int ND, int K>
__device__ int relax_tile(const Solve& s, const int* src, int* dst,
                          long long base, int y0, int x0, bool test,
                          unsigned char* sm) {
  using T = Tiles<ND>;
  constexpr int WW = RELAX_W + 2 * K, WH = RELAX_H + 2 * K, N = WW * WH;
  int* H0 = reinterpret_cast<int*>(sm);
  int* H1 = H0 + T::NR;
  uint8_t* A = reinterpret_cast<uint8_t*>(H1 + T::NR);
  const int W = s.W, inf = s.inf;
  const int wy0 = y0 - K, wx0 = x0 - K;
  // The arc bytes go through registers, all of a thread's loads started
  // before the first is stored.
  constexpr int PER = (N + THREADS - 1) / THREADS;
  uint8_t staged[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int wy = i / WW, wx = i - wy * WW;
    const int y = wy0 + wy, x = wx0 + wx;
    const long long g = base + (long long)y * W + x;
    staged[j] = 0;
    if (i < N && inside(s, y, x)) {
      cp_async(H0 + i, src + g);
      staged[j] = ld(s.arcs + g);
    } else if (i < N) {
      H0[i] = inf;
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (threadIdx.x + j * THREADS < N) A[threadIdx.x + j * THREADS] = staged[j];
  cp_async_wait();
  __syncthreads();
  bool last_lowered = false, lowered = false;
  for (int step = 0; step < K; ++step) {
    const int* a = step & 1 ? H1 : H0;
    int* b = step & 1 ? H0 : H1;
    for (int i = threadIdx.x; i < N; i += THREADS) {
      const int wy = i / WW, wx = i - wy * WW;
      const unsigned bits = A[i];
      const int hp = a[i];
      int nh = hp;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int dy = dir_y(d), dx = dir_x(d), o = dy * WW + dx;
        const bool fw = wy + dy >= 0 && wy + dy < WH && wx + dx >= 0 &&
                        wx + dx < WW;
        const bool bw = wy - dy >= 0 && wy - dy < WH && wx - dx >= 0 &&
                        wx - dx < WW;
        const int hf = fw ? a[i + o] : inf;
        nh = min(nh, hf + ((bits >> (2 * d)) & 1u ? 1 : inf));
        const int hb = bw ? a[i - o] : inf;
        nh = min(nh, hb + ((bits >> (2 * d + 1)) & 1u ? 1 : inf));
      }
      b[i] = nh;
      if (nh < hp && wy >= K && wy < K + RELAX_H && wx >= K &&
          wx < K + RELAX_W && inside(s, wy0 + wy, wx0 + wx)) {
        lowered = true;
        last_lowered |= step == K - 1;
      }
    }
    __syncthreads();
  }
  const int* res = K & 1 ? H1 : H0;
  for (int i = threadIdx.x; i < RELAX_H * RELAX_W; i += THREADS) {
    const int ty = i / RELAX_W, tx = i - ty * RELAX_W;
    const int y = y0 + ty, x = x0 + tx;
    if (y < s.H && x < W)
      dst[base + (long long)y * W + x] = res[(ty + K) * WW + tx + K];
  }
  const int flags = __syncthreads_or(test && last_lowered) ? LAST_LOWERED : 0;
  return flags | (__syncthreads_or(lowered) ? LOWERED : 0);
}

// relax_tile for a sub-block of k steps.
template <int ND>
__device__ int relax_steps(const Solve& s, const int* src, int* dst,
                           long long base, int y0, int x0, int k, bool test,
                           unsigned char* sm) {
  static_assert(RELAX_HALO == 4, "one case a sub-block size");
  switch (k) {
    case 1: return relax_tile<ND, 1>(s, src, dst, base, y0, x0, test, sm);
    case 2: return relax_tile<ND, 2>(s, src, dst, base, y0, x0, test, sm);
    case 3: return relax_tile<ND, 3>(s, src, dst, base, y0, x0, test, sm);
    default: return relax_tile<ND, 4>(s, src, dst, base, y0, x0, test, sm);
  }
}

// The global relabel of the images in the set of round `lo` (lo < 0: all),
// into h[cur], which it leaves pointing at the result.  The set's state is
// in set sp; with lo < 0 each image's is in set (rounds x n_sweeps) mod 2,
// and an odd one is copied back into set 0.
template <int ND>
__device__ void global_relabel(const Solve& s, cg::grid_group& g, int lo,
                               int sp, int& cur, int& stamp, Tally& t,
                               unsigned char* sm, int* img) {
  const int W = s.W, inf = s.inf;
  const unsigned long long start = clock_ns();
  int* h0 = s.h[cur];
  const int* stamps = img + s.B;
  auto member = [&](int b) { return in_set(img, lo, b); };
  each_pixel(s, member, [&](int b, long long i, int y, int x) {
    const int p = lo < 0 ? (img[b] * s.n_sweeps) & 1 : sp;
    unsigned bits = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int dy = dir_y(d), dx = dir_x(d);
      const float rf = ld(s.rf[p][d] + i);
      if (rf > 0.0f) bits |= 1u << (2 * d);
      if (inside(s, y - dy, x - dx) &&
          ld(s.rb[p][d] + i - (dy * W + dx)) > 0.0f)
        bits |= 2u << (2 * d);
      if (p) {
        s.rf[0][d][i] = rf;
        s.rb[0][d][i] = ld(s.rb[1][d] + i);
      }
    }
    const float ev = ld(s.e[p] + i);
    if (p) s.e[0][i] = ev;
    s.arcs[i] = (uint8_t)bits;
    h0[i] = ev < 0.0f ? 0 : inf;
  });
  // Sub-blocks run; relax tiles in each image's rows and columns.
  int sub = 0;
  const int rnx = (s.W + RELAX_W - 1) / RELAX_W;
  const int rny = (s.H + RELAX_H - 1) / RELAX_H;
  // Every image of the set relaxes in the first block.
  if (g.thread_rank() == 0)
    for (int b = 0; b < s.B; ++b)
      if (member(b)) st_volatile(stamp_of(s, b), stamp - 1);
  barrier(g, t);
  refresh(s, img);
  for (int it = 0; it < s.relabel_iters;) {
    const int mark = stamp;
    // Relaxed in this block: changed in the last one (stamp mark - 1; a
    // thread may already see this block's mark).  Stopped in the last one:
    // relaxed there (stamp mark - 2) and changed nothing.
    auto relaxes = [&](int b) {
      return member(b) && stamps[b] >= mark - 1;
    };
    auto stopped = [&](int b) {
      return member(b) && stamps[b] == mark - 2;
    };
    int relaxed = 0, copied = 0;
    if (g.thread_rank() == 0)
      for (int b = 0; b < s.B; ++b) {
        relaxed += relaxes(b);
        copied += stopped(b);
      }
    for (int done = 0; done < s.unroll; ++sub) {
      const int k = min(RELAX_HALO, s.unroll - done);
      const bool last = done + k == s.unroll;
      const int* src = s.h[cur];
      int* dst = s.h[cur ^ 1];
      const uint8_t* before = s.lowered[(sub + 1) & 1];
      uint8_t* now = s.lowered[sub & 1];
      each_tile(s, RELAX_H, RELAX_W, relaxes, [&](int b, int y0, int x0) {
        const int ty = y0 / RELAX_H, tx = x0 / RELAX_W;
        const long long at = ((long long)b * rny + ty) * rnx + tx;
        if (sub > 0) {
          // No height of the window moved in the last sub-block: the steps
          // would give what both buffers hold.
          bool moved = false;
          if (threadIdx.x < 9) {
            const int yy = ty + (int)threadIdx.x / 3 - 1;
            const int xx = tx + (int)threadIdx.x % 3 - 1;
            if (yy >= 0 && yy < rny && xx >= 0 && xx < rnx)
              moved = ld(before + ((long long)b * rny + yy) * rnx + xx);
          }
          if (!__syncthreads_or(moved)) {
            if (threadIdx.x == 0) {
              now[at] = 0;
              stat(t.relax_skipped);
            }
            return;
          }
        }
        const int flags = relax_steps<ND>(
            s, src, dst, (long long)b * s.H * W, y0, x0, k, last, sm);
        if (threadIdx.x == 0) {
          ++t.relaxed;
          now[at] = (flags & LOWERED) != 0;
          if (flags & LAST_LOWERED) st_volatile(stamp_of(s, b), mark);
        }
      });
      if (done == 0)
        each_pixel(s, stopped, [&](int, long long i, int, int) {
          dst[i] = ld(src + i);
        });
      barrier(g, t);
      cur ^= 1;
      done += k;
    }
    it += s.unroll;
    t.steps += s.unroll;
    t.image_steps += s.unroll * relaxed;
    t.copies += copied;
    // A later stamp is written only by threads that saw this one: >=.
    refresh(s, img);
    bool changed = false;
    for (int b = threadIdx.x; b < s.B; b += THREADS)
      changed |= member(b) && stamps[b] >= mark;
    ++stamp;
    if (!__syncthreads_or(changed)) break;
  }
  t.relabel_ns += clock_ns() - start;
}

// Push sweep k of the solve, sweep j of round r, on the images live in
// round r: state in set sp and heights in h[cur], both flipped.  A tile
// whose window was quiet in sweep k - 1 of this round, as were the
// windows of its 8 neighbours (which hold the rest of its window), is
// skipped: its window is unchanged but for -0 turned +0, so still quiet,
// and its two state sets already hold the same bits, which this sweep
// would write.
template <int ND>
__device__ void push_sweep(const Solve& s, cg::grid_group& g, int r, int j,
                           int k, int& sp, int& cur, Tally& t,
                           unsigned char* sm, const int* img) {
  const unsigned long long start = clock_ns();
  const int* h = s.h[cur];
  int* hn = s.h[cur ^ 1];
  const int nx = (s.W + TILE_W - 1) / TILE_W;
  const int ny = (s.H + TILE_H - 1) / TILE_H;
  const uint8_t* before = s.quiet[(k + 1) & 1];
  uint8_t* now = s.quiet[k & 1];
  each_tile(s, TILE_H, TILE_W, [&](int b) { return img[b] >= r; },
            [&](int b, int y0, int x0) {
    const int ty = y0 / TILE_H, tx = x0 / TILE_W;
    const long long at = ((long long)b * ny + ty) * nx + tx;
    if (j > 0) {
      bool busy = false;
      if (threadIdx.x < 9) {
        const int yy = ty + (int)threadIdx.x / 3 - 1;
        const int xx = tx + (int)threadIdx.x % 3 - 1;
        if (yy >= 0 && yy < ny && xx >= 0 && xx < nx)
          busy = !ld(before + ((long long)b * ny + yy) * nx + xx);
      }
      if (!__syncthreads_or(busy)) {
        if (threadIdx.x == 0) now[at] = 1;
        return;
      }
    }
    const long long base = (long long)b * s.H * s.W;
    load_window<ND>(s, sp, h, base, y0, x0, Window<ND>(sm));
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
  barrier(g, t);
  t.sweep_ns += clock_ns() - start;
  sp ^= 1;
  cur ^= 1;
}

template <int ND>
__global__ void __launch_bounds__(THREADS, 2) grid_mincut_kernel(Solve s) {
  extern __shared__ __align__(16) unsigned char sm[];
  cg::grid_group g = cg::this_grid();
  Tally t;
  int* img = reinterpret_cast<int*>(sm + Tiles<ND>::SMEM);
  int cur = 0, sp = 0, stamp = 1, sweeps = 0;
  refresh(s, img);
  global_relabel<ND>(s, g, -1, sp, cur, stamp, t, sm, img);
  const int hw = s.H * s.W;
  const int stride = gridDim.x * blockDim.x;
  for (int r = 1; r <= s.max_outer; ++r) {
    // Live in round r: live in r - 1 (round number r - 1) and active.
    const int* h = s.h[cur];
    const float* e = s.e[sp];
    for (int b = 0; b < s.B; ++b) {
      if (img[b] < r - 1) continue;
      const long long base = (long long)b * hw;
      bool active = false;
      for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw && !active;
           p += stride)
        active = ld(e + base + p) > 1e-6f && ld(h + base + p) < s.inf;
      if (active) st_volatile(s.ctrl + CTRL_ACT + b, r);
    }
    barrier(g, t);
    refresh(s, img);
    bool any = false;
    for (int b = threadIdx.x; b < s.B; b += THREADS) any |= img[b] == r;
    if (!__syncthreads_or(any)) break;
    global_relabel<ND>(s, g, r, sp, cur, stamp, t, sm, img);
    for (int j = 0; j < s.n_sweeps; ++j)
      push_sweep<ND>(s, g, r, j, sweeps++, sp, cur, t, sm, img);
  }
  global_relabel<ND>(s, g, -1, sp, cur, stamp, t, sm, img);
  const int* h = s.h[cur];
  each_pixel(s, [](int) { return true; }, [&](int, long long i, int, int) {
    s.fg[i] = ld(h + i) >= s.inf;
  });
  if (threadIdx.x == 0) {
    atomicAdd(s.ctrl + CTRL_SWEPT, t.swept);
    atomicAdd(s.ctrl + CTRL_RELAXED, t.relaxed);
#ifdef GRID_MINCUT_STATS
    atomicAdd(s.ctrl + CTRL_QUIET, t.quiet);
    atomicAdd(s.ctrl + CTRL_RELAX_SKIPPED, t.relax_skipped);
#endif
  }
  if (g.thread_rank() == 0) {
    s.ctrl[CTRL_STEPS] = t.steps;
    s.ctrl[CTRL_BARRIERS] = t.barriers;
    s.ctrl[CTRL_IMAGE_STEPS] = t.image_steps;
    s.ctrl[CTRL_COPIES] = t.copies;
    s.ctrl[CTRL_SWEEP_US] = (int)(t.sweep_ns / 1000);
    s.ctrl[CTRL_RELABEL_US] = (int)(t.relabel_ns / 1000);
  }
}

__global__ void __launch_bounds__(THREADS) barrier_loop_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

// Dynamic shared memory a block of a B-image solve takes: the tiles', then
// each image's round number and relax stamp.
template <int ND>
int smem_for(int B) {
  return Tiles<ND>::SMEM + 8 * B;
}

// The solver's grid for B images: every block resident at once, as many as
// fit.  info (host, 10 ints or null): blocks, resident blocks per SM,
// registers, the sweep tile's rows and columns, its halo, dynamic shared
// memory per block, the relax tile's rows and columns, its largest halo.
template <int ND>
cudaError_t grid_for(int B, int* blocks, int* info) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grid_mincut_kernel<ND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_for<ND>(B));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_mincut_kernel<ND>, THREADS, smem_for<ND>(B));
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (info) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, grid_mincut_kernel<ND>);
    if (err != cudaSuccess) return err;
    const int v[10] = {*blocks, per_sm, attr.numRegs, TILE_H, TILE_W,
                       Tiles<ND>::HALO, smem_for<ND>(B), RELAX_H, RELAX_W,
                       RELAX_HALO};
    for (int i = 0; i < 10; ++i) info[i] = v[i];
  }
  return cudaSuccess;
}

template <int ND>
int launch(Solve s, cudaStream_t stream, int* info) {
  int blocks = 0;
  cudaError_t err = grid_for<ND>(s.B, &blocks, info);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel((const void*)grid_mincut_kernel<ND>,
                                    dim3(blocks), dim3(THREADS), args,
                                    smem_for<ND>(s.B), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool valid_shape(int n_dirs, int B, int H, int W) {
  // INF = H W + 1, and INF + INF must not overflow an int.
  return (n_dirs == 2 || n_dirs == 4) && B > 0 && H > 0 && W > 0 &&
         (long long)H * W < (1LL << 29);
}

}  // namespace

// Solves B lattices in place.  `e` and the 2 n_dirs residual planes
// (rf[0..n_dirs), then rb[0..n_dirs)) are float32 (B, H, W); `work` holds
// B H W int32 words twice (two height planes), then B H W float32 words 1 +
// 2 n_dirs times (the second set of e and the residual planes), then B H W
// bytes of arcs, then 4 B ceil(H / 8) ceil(W / 8) bytes of tile flags (for
// sweep and relax tiles of 8 x 8 or more); `fg` B H W bytes; `ctrl` 10 + 2
// B int32, zero.  info: see grid_for (its halo is the one the sweep's tiles
// were compiled with, which the caller checks against its own).
extern "C" int grid_mincut(int n_dirs, int B, int H, int W, int max_outer,
                           int n_sweeps, int relabel_iters, int unroll,
                           void* e, void** rf, void** rb, void* work,
                           void* fg, void* ctrl, void* stream, int* info) {
  if (!valid_shape(n_dirs, B, H, W) || unroll < 1 || n_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  Solve s;
  const long long n = (long long)B * H * W;
  s.h[0] = (int*)work;
  s.h[1] = s.h[0] + n;
  float* second = (float*)(s.h[1] + n);
  s.e[0] = (float*)e;
  s.e[1] = second;
  for (int d = 0; d < MAX_DIRS; ++d) {
    const bool on = d < n_dirs;
    s.rf[0][d] = on ? (float*)rf[d] : nullptr;
    s.rb[0][d] = on ? (float*)rb[d] : nullptr;
    s.rf[1][d] = on ? second + (1 + d) * n : nullptr;
    s.rb[1][d] = on ? second + (1 + n_dirs + d) * n : nullptr;
  }
  s.arcs = (uint8_t*)(second + (1 + 2 * n_dirs) * n);
  static_assert(TILE_H >= 8 && TILE_W >= 8 && RELAX_H >= 8 && RELAX_W >= 8,
                "the tile flags' room");
  const long long room = (long long)B * ((H + 7) / 8) * ((W + 7) / 8);
  s.quiet[0] = s.arcs + n;
  s.quiet[1] = s.quiet[0] + room;
  s.lowered[0] = s.quiet[1] + room;
  s.lowered[1] = s.lowered[0] + room;
  s.fg = (uint8_t*)fg;
  s.ctrl = (int*)ctrl;
  s.B = B;
  s.H = H;
  s.W = W;
  s.inf = H * W + 1;
  s.max_outer = max_outer;
  s.n_sweeps = n_sweeps;
  s.relabel_iters = relabel_iters;
  s.unroll = unroll;
  const cudaStream_t st = (cudaStream_t)stream;
  return n_dirs == 4 ? launch<4>(s, st, info) : launch<2>(s, st, info);
}

// `n` empty grid-wide barriers on the grid grid_mincut launches for
// n_dirs: the barrier floor of a solve (H and W are checked as a solve's).
extern "C" int grid_barrier_loop(int n_dirs, int H, int W, int n,
                                 void* stream) {
  if (!valid_shape(n_dirs, 1, H, W) || n < 0)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = n_dirs == 4 ? grid_for<4>(1, &blocks, nullptr)
                                : grid_for<2>(1, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
