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
// changes no height of the set or relabel_iters steps are done: the batch
// relaxes until its last image stops changing.  A push sweep runs each
// direction's forward push (p -> p + off) and then its backward push (p ->
// p - off along the neighbour's r_bwd), each reading the state its
// predecessor left, then lifts the overflowing pixels: the plain version's
// order.  Each directed push does its float32 operations in the plain
// version's order: f = can ? min(e, r) : +0, r_fwd - f and r_bwd + f,
// (e - f) + f_shifted.  Adds of +0 are done too (-0 + +0 is +0), and there
// is no multiply to contract: the build has no --use_fast_math.  Out of the
// image a height reads INF and a residual or flow 0, the plain version's
// padding.
//
// Bound.  Bytes: each step of a solve reads its state once and writes it
// once, over 3.35 TB/s on an H100 (per pixel: a push sweep reads and
// writes e, the heights and both residual planes of each of D directions,
// 16 + 16 D bytes; a relax step 9 bytes), the steps following from the
// solve's tallies.  This design moves more: a sweep's 2 D + 2 passes also
// write and read the flow planes and read e and the heights again, 20 +
// 84 D bytes a pixel, 4.5 times the bound's at D = 4.  Barriers: every
// pass but the last ends in a grid-wide barrier, so a solve of N passes
// cannot take less than N - 1 barriers (chip_smoke times an empty barrier
// loop on the same grid).  On GrabCut's solves the bytes bound is 1-3.5
// times the barrier floor: the fewer pixels a barrier's pass covers, the
// more the barriers weigh.

// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with no more blocks than fit on the SMs at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and no more than one
// image's pixels need; threads walk each set image's pixels grid-stride,
// and cooperative_groups' grid sync separates dependent passes.  Hazards:
// a push writes its flow to a plane (ff forward, fb backward) in one pass
// and the receiver adds it in the next, so no pass reads a value that
// another thread of the same pass writes; the previous direction's
// backward receive merges with the next direction's forward push (both
// local to p).  Heights are double-buffered.  Control is uniform: every
// thread takes each branch from values written before the barrier it has
// just passed -- the last relax step stores a stamp that only grows (no
// reset), the round test stores the round number per image (`act`, which
// ends as each image's round count).  Values written inside the launch are
// read with ld.global.cg (L2, the point of coherence), never through L1.
// The wrapper allocates every buffer; the kernel allocates nothing.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIRS = 4;
// ctrl: the changed stamp, relabel steps, barriers, relabel image-steps,
// then one round number per image.
constexpr int CTRL_STAMP = 0, CTRL_STEPS = 1, CTRL_BARRIERS = 2,
              CTRL_IMAGE_STEPS = 3, CTRL_ACT = 4;

struct Solve {
  float* e;
  float* rf[MAX_DIRS];
  float* rb[MAX_DIRS];
  int* h[2];
  float* ff;
  float* fb;
  uint8_t* arcs;   // the relabel's usable arcs: bit 2d forward, 2d+1 back
  uint8_t* fg;
  int* ctrl;
  int B, H, W, inf;
  int max_outer, n_sweeps, relabel_iters, unroll;
};

// OFFSETS_8 = (0, -1), (-1, 0), (-1, -1), (-1, 1); OFFSETS_4 its first two.
__device__ __forceinline__ int dir_y(int d) { return d == 0 ? 0 : -1; }
__device__ __forceinline__ int dir_x(int d) {
  return d == 0 ? -1 : (d == 1 ? 0 : (d == 2 ? -1 : 1));
}

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

__device__ __forceinline__ int ld_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ bool inside(const Solve& s, int y, int x) {
  return y >= 0 && y < s.H && x >= 0 && x < s.W;
}

// Calls body(i, y, x) for every pixel of every image whose round number is
// at least `lo` (lo < 0: every image), grid-stride within each image.
template <class Body>
__device__ __forceinline__ void each_pixel(const Solve& s, int lo, Body body) {
  const int hw = s.H * s.W;
  const int stride = gridDim.x * blockDim.x;
  for (int b = 0; b < s.B; ++b) {
    if (lo >= 0 && ld(s.ctrl + CTRL_ACT + b) < lo) continue;
    const long long base = (long long)b * hw;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw; p += stride) {
      const int y = p / s.W;
      body(base + p, y, p - y * s.W);
    }
  }
}

// Tallies kept by thread 0 of the grid, written to ctrl at the end.
struct Tally {
  int steps = 0, barriers = 0, image_steps = 0;
};

__device__ __forceinline__ void barrier(cg::grid_group& g, Tally& t) {
  ++t.barriers;
  g.sync();
}

// The global relabel of the images whose round number is at least `lo`
// (lo < 0: all), into h[cur], which it leaves pointing at the result.
template <int ND>
__device__ void global_relabel(const Solve& s, cg::grid_group& g, int lo,
                               int& cur, int& stamp, Tally& t) {
  const int W = s.W, inf = s.inf;
  int* h0 = s.h[cur];
  each_pixel(s, lo, [&](long long i, int y, int x) {
    unsigned bits = 0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int dy = dir_y(d), dx = dir_x(d);
      if (ld(s.rf[d] + i) > 0.0f) bits |= 1u << (2 * d);
      if (inside(s, y - dy, x - dx) && ld(s.rb[d] + i - (dy * W + dx)) > 0.0f)
        bits |= 2u << (2 * d);
    }
    s.arcs[i] = (uint8_t)bits;
    h0[i] = ld(s.e + i) < 0.0f ? 0 : inf;
  });
  barrier(g, t);
  int set_size = 0;
  if (g.thread_rank() == 0)
    for (int b = 0; b < s.B; ++b)
      set_size += lo < 0 || ld_volatile(s.ctrl + CTRL_ACT + b) >= lo;
  for (int it = 0; it < s.relabel_iters;) {
    for (int k = 0; k < s.unroll; ++k) {
      const int* src = s.h[cur];
      int* dst = s.h[cur ^ 1];
      const bool last = k == s.unroll - 1;
      const int mark = stamp;
      each_pixel(s, lo, [&](long long i, int y, int x) {
        const unsigned bits = ld(s.arcs + i);
        const int hp = ld(src + i);
        int nh = hp;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          const int dy = dir_y(d), dx = dir_x(d), o = dy * W + dx;
          const int hf = inside(s, y + dy, x + dx) ? ld(src + i + o) : inf;
          nh = min(nh, hf + ((bits >> (2 * d)) & 1u ? 1 : inf));
          const int hb = inside(s, y - dy, x - dx) ? ld(src + i - o) : inf;
          nh = min(nh, hb + ((bits >> (2 * d + 1)) & 1u ? 1 : inf));
        }
        dst[i] = nh;
        if (last && nh < hp)
          *reinterpret_cast<volatile int*>(s.ctrl + CTRL_STAMP) = mark;
      });
      barrier(g, t);
      cur ^= 1;
    }
    it += s.unroll;
    t.steps += s.unroll;
    t.image_steps += s.unroll * set_size;
    // A later stamp is written only by threads that saw this one: >=.
    const bool changed = ld_volatile(s.ctrl + CTRL_STAMP) >= stamp;
    ++stamp;
    if (!changed) break;
  }
}

// One push sweep of the images live in round r, heights in h[cur].
template <int ND>
__device__ void push_sweep(const Solve& s, cg::grid_group& g, int r,
                           int& cur, Tally& t) {
  const int W = s.W, inf = s.inf;
  const int* h = s.h[cur];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int dy = dir_y(d), dx = dir_x(d), o = dy * W + dx;
    // p receives the previous direction's backward flow from p + off', then
    // pushes p -> p + off along r_fwd.
    each_pixel(s, r, [&](long long i, int y, int x) {
      float ev = ld(s.e + i);
      if (d > 0) {
        const int py = dir_y(d - 1), px = dir_x(d - 1);
        const float back = inside(s, y + py, x + px)
                               ? ld(s.fb + i + (py * W + px)) : 0.0f;
        s.rb[d - 1][i] = ld(s.rb[d - 1] + i) - back;
        s.rf[d - 1][i] = ld(s.rf[d - 1] + i) + back;
        ev = ev + back;
      }
      const int hp = ld(h + i);
      const int hq = inside(s, y + dy, x + dx) ? ld(h + i + o) : inf;
      const float res = ld(s.rf[d] + i);
      const bool can = ev > 0.0f && hp < inf && hp == hq + 1 && res > 0.0f;
      const float f = can ? fminf(ev, res) : 0.0f;
      s.rf[d][i] = res - f;
      s.rb[d][i] = ld(s.rb[d] + i) + f;
      s.e[i] = ev - f;
      s.ff[i] = f;
    });
    barrier(g, t);
    // p receives the forward flow from p - off, then pushes p -> p - off
    // along the neighbour's r_bwd.
    each_pixel(s, r, [&](long long i, int y, int x) {
      const bool nb = inside(s, y - dy, x - dx);
      const float ev = ld(s.e + i) + (nb ? ld(s.ff + i - o) : 0.0f);
      const int hp = ld(h + i);
      const int hq = nb ? ld(h + i - o) : inf;
      const float res = nb ? ld(s.rb[d] + i - o) : 0.0f;
      const bool can = ev > 0.0f && hp < inf && hp == hq + 1 && res > 0.0f;
      const float f = can ? fminf(ev, res) : 0.0f;
      s.e[i] = ev - f;
      s.fb[i] = f;
    });
    barrier(g, t);
  }
  {
    // The last direction's backward flow arrives at p - off from p.
    const int dy = dir_y(ND - 1), dx = dir_x(ND - 1), o = dy * W + dx;
    each_pixel(s, r, [&](long long i, int y, int x) {
      const float back = inside(s, y + dy, x + dx) ? ld(s.fb + i + o) : 0.0f;
      s.rb[ND - 1][i] = ld(s.rb[ND - 1] + i) - back;
      s.rf[ND - 1][i] = ld(s.rf[ND - 1] + i) + back;
      s.e[i] = ld(s.e + i) + back;
    });
    barrier(g, t);
  }
  // Relabel: overflowing pixels lift to 1 + the lowest reachable neighbour.
  int* hn = s.h[cur ^ 1];
  each_pixel(s, r, [&](long long i, int y, int x) {
    const int hp = ld(h + i);
    int nh = inf;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int dy = dir_y(d), dx = dir_x(d), o = dy * W + dx;
      if (ld(s.rf[d] + i) > 0.0f)
        nh = min(nh, (inside(s, y + dy, x + dx) ? ld(h + i + o) : inf) + 1);
      if (inside(s, y - dy, x - dx) && ld(s.rb[d] + i - o) > 0.0f)
        nh = min(nh, ld(h + i - o) + 1);
    }
    const float ev = ld(s.e + i);
    const int lifted = ev > 0.0f && hp < inf ? max(hp, nh) : hp;
    hn[i] = ev < 0.0f ? 0 : lifted;
  });
  barrier(g, t);
  cur ^= 1;
}

template <int ND>
__global__ void __launch_bounds__(THREADS) grid_mincut_kernel(Solve s) {
  cg::grid_group g = cg::this_grid();
  Tally t;
  int cur = 0, stamp = 1;
  global_relabel<ND>(s, g, -1, cur, stamp, t);
  const int hw = s.H * s.W;
  const int stride = gridDim.x * blockDim.x;
  for (int r = 1; r <= s.max_outer; ++r) {
    // Live in round r: live in r - 1 (round number r - 1) and active.
    const int* h = s.h[cur];
    for (int b = 0; b < s.B; ++b) {
      if (ld(s.ctrl + CTRL_ACT + b) < r - 1) continue;
      const long long base = (long long)b * hw;
      bool active = false;
      for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw && !active;
           p += stride)
        active = ld(s.e + base + p) > 1e-6f && ld(h + base + p) < s.inf;
      if (active) *reinterpret_cast<volatile int*>(s.ctrl + CTRL_ACT + b) = r;
    }
    barrier(g, t);
    bool any = false;
    for (int b = 0; b < s.B; ++b)
      any |= ld_volatile(s.ctrl + CTRL_ACT + b) == r;
    if (!any) break;
    global_relabel<ND>(s, g, r, cur, stamp, t);
    for (int k = 0; k < s.n_sweeps; ++k) push_sweep<ND>(s, g, r, cur, t);
  }
  global_relabel<ND>(s, g, -1, cur, stamp, t);
  const int* h = s.h[cur];
  each_pixel(s, -1, [&](long long i, int, int) {
    s.fg[i] = ld(h + i) >= s.inf;
  });
  if (g.thread_rank() == 0) {
    s.ctrl[CTRL_STEPS] = t.steps;
    s.ctrl[CTRL_BARRIERS] = t.barriers;
    s.ctrl[CTRL_IMAGE_STEPS] = t.image_steps;
  }
}

__global__ void __launch_bounds__(THREADS) barrier_loop_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

// The solver's grid for an image of hw pixels: every block resident at
// once, and no more blocks than one image's pixels fill.
template <int ND>
cudaError_t grid_for(long long hw, int* blocks, int* info) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_mincut_kernel<ND>, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long want = (hw + THREADS - 1) / THREADS;
  *blocks = (int)(want < (long long)per_sm * sms ? want
                                                 : (long long)per_sm * sms);
  if (info) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, grid_mincut_kernel<ND>);
    if (err != cudaSuccess) return err;
    info[0] = *blocks;
    info[1] = per_sm;
    info[2] = attr.numRegs;
  }
  return cudaSuccess;
}

template <int ND>
int launch(Solve s, cudaStream_t stream, int* info) {
  int blocks = 0;
  cudaError_t err = grid_for<ND>((long long)s.H * s.W, &blocks, info);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&s};
  err = cudaLaunchCooperativeKernel((const void*)grid_mincut_kernel<ND>,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    stream);
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
// 4 B H W int32 / float32 words (two height planes, the two flow planes)
// then B H W bytes of arcs; `fg` B H W bytes; `ctrl` 4 + B int32, zero.
// info (host, 3 ints or null): blocks, resident blocks per SM, registers.
extern "C" int grid_mincut(int n_dirs, int B, int H, int W, int max_outer,
                           int n_sweeps, int relabel_iters, int unroll,
                           void* e, void** rf, void** rb, void* work,
                           void* fg, void* ctrl, void* stream, int* info) {
  if (!valid_shape(n_dirs, B, H, W) || unroll < 1 || n_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  Solve s;
  const long long n = (long long)B * H * W;
  s.e = (float*)e;
  for (int d = 0; d < MAX_DIRS; ++d) {
    s.rf[d] = d < n_dirs ? (float*)rf[d] : nullptr;
    s.rb[d] = d < n_dirs ? (float*)rb[d] : nullptr;
  }
  s.h[0] = (int*)work;
  s.h[1] = s.h[0] + n;
  s.ff = (float*)(s.h[1] + n);
  s.fb = s.ff + n;
  s.arcs = (uint8_t*)(s.fb + n);
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

// `n` empty grid-wide barriers on the grid grid_mincut would launch for
// (n_dirs, H, W): the barrier floor of a solve.
extern "C" int grid_barrier_loop(int n_dirs, int H, int W, int n,
                                 void* stream) {
  if (!valid_shape(n_dirs, 1, H, W) || n < 0)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const long long hw = (long long)H * W;
  cudaError_t err = n_dirs == 4 ? grid_for<4>(hw, &blocks, nullptr)
                                : grid_for<2>(hw, &blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
