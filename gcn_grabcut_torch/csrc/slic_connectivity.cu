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
//      on a tie.
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
// over 3.35 TB/s on an H100.  This design moves more: the orphan pass
// reads a 50 x 50 window for a 32 x 32 tile, each component super-block
// and absorption pass a 48 x 48 window for each tile it runs, the size,
// score and flag passes read the components and labels again.  Barriers:
// one an orphan pass (up to 4 sweeps), one a super-block of SUPER Jacobi
// steps, three for sizes, scores and flags, one an absorption pass of
// ABS_ROUNDS rounds.
//
// Design.  One persistent cooperative launch (cudaLaunchCooperativeKernel
// on the caller's stream) with as many blocks of 256 threads as fit on the
// SMs at once (three); cooperative_groups' grid sync separates the passes.
//  - Orphans: one pass over 32 x 32 tiles.  A block loads a tile's window
//    with a halo of 2 sweeps + 1 into shared memory and runs the half-sweeps
//    there in place (a half-sweep writes one parity and reads the other;
//    its threads walk that parity's pixels only), each valid on a window
//    one pixel smaller; it writes the tile's labels and, for the
//    components, each pixel's same-label relation as 4 bits (up, down,
//    left, right) from the final labels of the halo's inner ring.
//  - Components: super-blocks of SUPER Jacobi steps (a multiple of 4) per
//    barrier, each tile on a window with a halo of SUPER in shared memory:
//    the state after t steps is the least index over the geodesic ball of
//    radius t in the pixel's same-label component, so the tile's interior
//    is exact.  A thread keeps its window pixels' components and bits in
//    registers and exchanges them through two shared planes.  Skip lemma:
//    a pixel that changes at step t + 1 has a neighbour that changed at
//    step t, so a tile none of whose 3 x 3 neighbour tiles (SUPER <= TILE)
//    changed in the last step of the previous super-block changes nothing
//    in the next: it is skipped exactly.  A tile that changed in its last
//    step lists its neighbour tiles for the next pass (once each, by a
//    stamp), and the blocks take the listed tiles one at a time from a
//    counter; a stage's first pass takes every tile.  Each tile's values
//    live in one of two planes: a tile that runs writes the other one and
//    records it with the pass that wrote it, so a neighbour reading it in
//    the same pass still takes its old plane, and a skipped tile's record
//    stands.  Each image records the last step D at which any of its
//    pixels changed; the plain version's blocks are then min(max_sweeps,
//    (D + 3) / 4 + 1), and the last super-block stops at exactly 4
//    max_sweeps steps, the plain version's cap.
//  - Sizes, scores and flags: three passes over the tiles; a warp's lanes
//    with the same component (__match_any_sync) make one atomic between
//    them (integer adds: any order gives the same bits; the per-label
//    maximum an integer max on ordered bits).
//  - Absorption: passes of ABS_ROUNDS rounds (4 ABS_ROUNDS <= SUPER
//    phases) on the same windows and tile lists, the labels and minor
//    flags in two planes each: a phase reads only a pixel's neighbours, so
//    the halo keeps the interior exact, and a phase writes one parity and
//    reads the other, so it runs in place in any order.  A pixel that
//    moves in phase t >= 2 has a neighbour that moved in phase t - 1: a
//    tile none of whose neighbour tiles moved in the last phase of the
//    previous pass is skipped exactly.  An image at its fixpoint moves
//    nothing in further rounds, so a pass runs them all; each image records
//    the last round R in which it moved, and the plain version's rounds
//    are min(max_sweeps, R + 2) (it runs one more, which moves nothing).
//    A last pass copies the tiles whose labels ended in the second plane.
// Loop control reads counts that no block writes in the same pass (slots
// by pass modulo 3), so every block takes the same branch.  Data written
// in the launch is read by ld.global.cg (L2) after a grid barrier, whose
// fence orders it after the writes before the barrier.  The wrapper
// allocates every buffer; the kernel allocates nothing.  With
// SLIC_CONNECTIVITY_STATS defined, thread 0 of the grid also times each
// stage on the card's nanosecond clock (the committed build leaves it out).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 32;                 // a tile's interior
constexpr int SUPER = 8;                 // Jacobi steps a super-block
constexpr int CWIN = TILE + 2 * SUPER;   // its window, halo included
constexpr int CWIN2 = CWIN * CWIN;
constexpr int CPER = (CWIN2 + THREADS - 1) / THREADS;  // pixels a thread
constexpr int ABS_ROUNDS = 2;            // absorption rounds a pass
constexpr int ORPHAN_SWEEPS = 4;         // orphan sweeps a pass
constexpr int OHALO = 2 * ORPHAN_SWEEPS + 1;
constexpr int OWIN = TILE + 2 * OHALO;
constexpr int OWIN2 = OWIN * OWIN;
static_assert(SUPER % 4 == 0 && SUPER <= TILE && 4 * ABS_ROUNDS <= SUPER,
              "a super-block is whole blocks; its halo within a tile and "
              "an absorption pass's phases within it");
static_assert(CPER <= 32 && 2 * CWIN2 >= OWIN2 && OWIN % 2 == 0,
              "the shared planes' room; a window row's parities");

constexpr uint8_t UP = 1, DOWN = 2, LEFT = 4, RIGHT = 8;

// ctrl's words: per image the last step its components changed and the
// last absorption round (+ 1) it moved in; the active tiles' lists'
// lengths and take counters (3 slots each); then the tallies, ending with
// the plain version's blocks and rounds.
enum {
  CT_TILES_RUN, CT_TILES_SKIPPED, CT_BARRIERS, CT_SUPER_BLOCKS, CT_STEPS,
  CT_MINOR, CT_ABS_RUN, CT_ABS_SKIPPED, CT_ABS_PASSES, CT_ORPHAN_NS,
  CT_COMP_NS, CT_SCORE_NS, CT_ABSORB_NS, CT_BLOCKS, CT_ROUNDS, CT_TAIL
};

struct Job {
  const int* in;         // (B, H, W) labels in
  int* lab;              // (B, H, W) labels out, updated in place
  int* comp[2];          // (B, H, W) component planes
  int* size;             // (B, H W) component sizes
  unsigned* best;        // (B, k) each label's best score, ordered bits
  int* where;            // (B, tiles) a tile's plane | (the pass that
                         // wrote it + 1) << 1
  int* queued;           // (B, tiles) the pass (+ 1) a tile is listed for
  int* active[2];        // (B tiles) the tiles a pass runs
  uint8_t* bits;         // (B, H, W) same-label relation
  uint8_t* minor[2];     // (B, H, W) minor flags, two planes
  int* last;             // (B) last step an image changed
  int* moved;            // (B) last absorption round (+ 1) an image moved
  int* tcount;           // (3) active list lengths, by pass % 3
  int* tnext;            // (3) their take counters
  int* tail;             // CT_TAIL tallies
  int B, H, W, k, absorb_sweeps, max_sweeps, ty_n, tx_n;
};

template <class T>
__device__ __forceinline__ T ld(const T* p) { return __ldcg(p); }

// The float's bits in an order that an unsigned max keeps.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// size H W - comp, each operation rounded on its own.
__device__ __forceinline__ float score(int size, int hw, int comp) {
  return __fsub_rn(__fmul_rn((float)size, (float)hw), (float)comp);
}

// The plane holding a tile's components as super-block k starts, from its
// where word: a tile written in k itself still has them in the other one.
__device__ __forceinline__ int plane_at(int w, int k) {
  return (w >> 1) == k + 1 ? 1 - (w & 1) : (w & 1);
}

// Tallies kept by thread 0 of the grid (barriers, tiles, times) and by
// thread 0 of each block (its tiles run), added to ctrl at the end.
struct Tally {
  int run = 0, skipped = 0, barriers = 0, abs_run = 0, abs_skipped = 0;
  unsigned long long at = 0, ns[4] = {0, 0, 0, 0};
};

// The card's nanosecond clock with SLIC_CONNECTIVITY_STATS (else 0).
__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t = 0;
#ifdef SLIC_CONNECTIVITY_STATS
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}

// A grid barrier that closes a stage: thread 0 of the grid adds the time
// since the last one to stage `st`.
__device__ __forceinline__ void barrier(cg::grid_group& g, Tally& t, int st) {
  g.sync();
  if (g.thread_rank() == 0) {
    ++t.barriers;
    const unsigned long long now = clock_ns();
    t.ns[st] += now - t.at;
    t.at = now;
  }
}

// One orphan pass of `sweeps` (<= ORPHAN_SWEEPS) sweeps, src -> dst, tile
// by tile; with `finish`, also each pixel's same-label bits and a zero
// size.  A half-sweep's threads walk its parity's pixels only.
__device__ void orphan_pass(const Job& j, const int* src, int* dst,
                            int sweeps, bool finish, int* s) {
  const int hw = j.H * j.W;
  const long long tiles = (long long)j.B * j.ty_n * j.tx_n;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int b = (int)(t / (j.ty_n * j.tx_n));
    const int tr = (int)(t % (j.ty_n * j.tx_n));
    const int y0 = (tr / j.tx_n) * TILE - OHALO;
    const int x0 = (tr % j.tx_n) * TILE - OHALO;
    const int* L = src + (long long)b * hw;
    __syncthreads();                     // the last tile's reads are done
    for (int i = threadIdx.x; i < OWIN2; i += THREADS) {
      const int y = y0 + i / OWIN, x = x0 + i % OWIN;
      s[i] = (y >= 0 && y < j.H && x >= 0 && x < j.W) ? ld(L + y * j.W + x)
                                                      : -1;
    }
    __syncthreads();
    for (int h = 0; h < 2 * sweeps; ++h) {
      const int parity = h & 1;
      for (int q = threadIdx.x; q < OWIN2 / 2; q += THREADS) {
        const int wy = q / (OWIN / 2), y = y0 + wy;
        const int wx = 2 * (q % (OWIN / 2)) + (parity ^ ((y + x0) & 1));
        const int x = x0 + wx, i = wy * OWIN + wx;
        if (wy < 1 || wy >= OWIN - 1 || wx < 1 || wx >= OWIN - 1 || y < 0 ||
            y >= j.H || x < 0 || x >= j.W)
          continue;
        const int c = s[i];
        const int nb[4] = {y > 0 ? s[i - OWIN] : c,
                           y < j.H - 1 ? s[i + OWIN] : c,
                           x > 0 ? s[i - 1] : c, x < j.W - 1 ? s[i + 1] : c};
        if (nb[0] == c || nb[1] == c || nb[2] == c || nb[3] == c) continue;
        int best = nb[0], best_n = 0;
        for (int a = 0; a < 4; ++a) {
          int cnt = 0;
          for (int o = 0; o < 4; ++o) cnt += nb[o] == nb[a];
          if (a == 0 || cnt > best_n) {
            best = nb[a];
            best_n = cnt;
          }
        }
        s[i] = best;
      }
      __syncthreads();
    }
    int* D = dst + (long long)b * hw;
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
      const int wy = OHALO + i / TILE, wx = OHALO + i % TILE;
      const int y = y0 + wy, x = x0 + wx;
      if (y >= j.H || x >= j.W) continue;
      const int w = wy * OWIN + wx, c = s[w];
      const int p = y * j.W + x;
      D[p] = c;
      if (finish) {
        j.bits[(long long)b * hw + p] =
            (y > 0 && s[w - OWIN] == c ? UP : 0) |
            (y < j.H - 1 && s[w + OWIN] == c ? DOWN : 0) |
            (x > 0 && s[w - 1] == c ? LEFT : 0) |
            (x < j.W - 1 && s[w + 1] == c ? RIGHT : 0);
        j.size[(long long)b * hw + p] = 0;
      }
    }
  }
}

// The blocks take the tiles of pass k (every tile when `all`, else those
// listed in pass k - 1) one at a time; tile(tl, b, ty, tx, plane) runs one,
// plane[9] the planes of its 3 x 3 neighbour tiles as the pass started
// (not read when `all`), and returns whether its interior changed in the
// pass's last step (every thread the same), which lists its neighbour
// tiles for pass k + 1 (once each, by a stamp).
template <class Tile>
__device__ void take_tiles(const Job& j, int k, bool all, int n_active,
                           Tile tile) {
  __shared__ int s_take;
  __shared__ int s_plane[9];
  const int per = j.ty_n * j.tx_n;
  for (;;) {
    __syncthreads();                     // the last tile's reads are done
    if (threadIdx.x == 0) s_take = atomicAdd(j.tnext + k % 3, 1);
    __syncthreads();
    const int take = s_take;
    if (take >= n_active) break;
    const int tl = all ? take : ld(j.active[k & 1] + take);
    const int b = tl / per, tr = tl % per;
    const int ty = tr / j.tx_n, tx = tr % j.tx_n;
    if (threadIdx.x < 9) {
      const int ny = ty + threadIdx.x / 3 - 1, nx = tx + threadIdx.x % 3 - 1;
      if (!all && ny >= 0 && ny < j.ty_n && nx >= 0 && nx < j.tx_n)
        s_plane[threadIdx.x] =
            plane_at(ld(j.where + (long long)b * per + ny * j.tx_n + nx), k);
    }
    __syncthreads();
    const bool changed = tile(tl, b, ty, tx, s_plane);
    if (changed && threadIdx.x < 9) {
      const int ny = ty + threadIdx.x / 3 - 1, nx = tx + threadIdx.x % 3 - 1;
      if (ny >= 0 && ny < j.ty_n && nx >= 0 && nx < j.tx_n) {
        const int nb = b * per + ny * j.tx_n + nx;
        if (atomicExch(j.queued + nb, k + 1) != k + 1)
          j.active[(k + 1) & 1][atomicAdd(j.tcount + (k + 1) % 3, 1)] = nb;
      }
    }
  }
}

// Super-block k of n (<= SUPER) Jacobi steps of the components, `done`
// steps before it, in shared memory (s: two planes of CWIN2 words).
__device__ void super_block(const Job& j, int k, int done, int n,
                            int n_active, int* s, Tally& t) {
  __shared__ int s_last;
  int* buf[2] = {s, s + CWIN2};
  const int hw = j.H * j.W;
  take_tiles(j, k, k == 0, n_active, [&](int tl, int b, int ty, int tx,
                                         const int* plane) {
    if (threadIdx.x == 0) s_last = 0;
    const int y0 = ty * TILE - SUPER, x0 = tx * TILE - SUPER;
    const long long base = (long long)b * hw;
    int val[CPER];
    unsigned eb[(CPER + 7) / 8] = {};
    unsigned inner = 0;
#pragma unroll
    for (int m = 0; m < CPER; ++m) {
      const int i = threadIdx.x + m * THREADS;
      if (i >= CWIN2) break;
      const int wy = i / CWIN, wx = i % CWIN;
      const int y = y0 + wy, x = x0 + wx;
      int v = hw;
      uint8_t e = 0;
      if (y >= 0 && y < j.H && x >= 0 && x < j.W) {
        const int p = y * j.W + x;
        v = k == 0 ? p
                   : ld(j.comp[plane[(y / TILE - ty + 1) * 3 +
                                     (x / TILE - tx + 1)]] +
                        base + p);
        e = ld(j.bits + base + p);
        if (wy == 0) e &= ~UP;
        if (wy == CWIN - 1) e &= ~DOWN;
        if (wx == 0) e &= ~LEFT;
        if (wx == CWIN - 1) e &= ~RIGHT;
        if (wy >= SUPER && wy < SUPER + TILE && wx >= SUPER &&
            wx < SUPER + TILE)
          inner |= 1u << m;
      }
      val[m] = v;
      eb[m / 8] |= (unsigned)e << (4 * (m % 8));
      buf[0][i] = v;
    }
    __syncthreads();
    int last = 0;
    for (int step = 1; step <= n; ++step) {
      const int* from = buf[(step - 1) & 1];
      int* to = buf[step & 1];
#pragma unroll
      for (int m = 0; m < CPER; ++m) {
        const int i = threadIdx.x + m * THREADS;
        if (i >= CWIN2) break;
        const unsigned e = (eb[m / 8] >> (4 * (m % 8))) & 15u;
        int v = val[m];
        if (e & UP) v = min(v, from[i - CWIN]);
        if (e & DOWN) v = min(v, from[i + CWIN]);
        if (e & LEFT) v = min(v, from[i - 1]);
        if (e & RIGHT) v = min(v, from[i + 1]);
        if (v < val[m] && (inner >> m & 1u)) last = step;
        val[m] = v;
        to[i] = v;
      }
      __syncthreads();
    }
    if (last) atomicMax(&s_last, last);
    const int out_plane = k == 0 ? 0 : 1 - plane[4];
    int* out = j.comp[out_plane] + base;
#pragma unroll
    for (int m = 0; m < CPER; ++m) {
      const int i = threadIdx.x + m * THREADS;
      if (i < CWIN2 && (inner >> m & 1u))
        out[(y0 + i / CWIN) * j.W + x0 + i % CWIN] = val[m];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      j.where[tl] = out_plane | ((k + 1) << 1);
      ++t.run;
      if (s_last) atomicMax(j.last + b, done + s_last);
    }
    return s_last == n;
  });
}

// Pass k of absorption: rounds `done` to done + n (n <= ABS_ROUNDS) of
// four phases each, every tile's on its window in shared memory (s: the
// labels, then the minor flags), the labels and flags in two planes each
// (plane 0: the output labels and j.minor[0]).
__device__ void absorb_pass(const Job& j, int k, bool all, int done, int n,
                            int n_active, int* s, Tally& t) {
  __shared__ unsigned s_rounds;
  int* L = s;
  uint8_t* M = (uint8_t*)(s + CWIN2);
  int* lab[2] = {j.lab, j.comp[0]};
  const int hw = j.H * j.W;
  const int phases = 4 * n;
  take_tiles(j, k, all, n_active, [&](int tl, int b, int ty, int tx,
                                      const int* plane) {
    if (threadIdx.x == 0) s_rounds = 0;
    const int y0 = ty * TILE - SUPER, x0 = tx * TILE - SUPER;
    const long long base = (long long)b * hw;
    for (int i = threadIdx.x; i < CWIN2; i += THREADS) {
      const int y = y0 + i / CWIN, x = x0 + i % CWIN;
      if (y >= 0 && y < j.H && x >= 0 && x < j.W) {
        const int pl = all ? 0 : plane[(y / TILE - ty + 1) * 3 +
                                       (x / TILE - tx + 1)];
        const long long p = base + y * j.W + x;
        L[i] = ld(lab[pl] + p);
        M[i] = ld(j.minor[pl] + p);
      } else {
        M[i] = 2;                        // out of the image: never moves,
      }                                  // never taken
    }
    __syncthreads();
    unsigned rounds = 0;
    bool at_last = false;
    for (int ph = 0; ph < phases; ++ph) {
      const int parity = ph & 1;
      for (int q = threadIdx.x; q < CWIN2 / 2; q += THREADS) {
        const int wy = q / (CWIN / 2);
        const int wx = 2 * (q % (CWIN / 2)) + (parity ^ ((y0 + wy + x0) & 1));
        const int i = wy * CWIN + wx;
        if (wy < 1 || wy >= CWIN - 1 || wx < 1 || wx >= CWIN - 1 ||
            M[i] != 1)
          continue;
        const int from = !M[i - CWIN] ? i - CWIN
                         : !M[i + CWIN] ? i + CWIN
                         : !M[i - 1] ? i - 1
                         : !M[i + 1] ? i + 1 : -1;
        if (from < 0) continue;
        L[i] = L[from];
        M[i] = 0;
        if (wy >= SUPER && wy < SUPER + TILE && wx >= SUPER &&
            wx < SUPER + TILE) {
          rounds |= 1u << (ph / 4);
          at_last |= ph == phases - 1;
        }
      }
      __syncthreads();
    }
    if (rounds) atomicOr(&s_rounds, rounds);
    const bool changed = __syncthreads_or(at_last);
    const int out_plane = all ? 1 : 1 - plane[4];
    for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
      const int wy = SUPER + i / TILE, wx = SUPER + i % TILE;
      const int y = y0 + wy, x = x0 + wx;
      if (y >= j.H || x >= j.W) continue;
      const long long p = base + y * j.W + x;
      lab[out_plane][p] = L[wy * CWIN + wx];
      j.minor[out_plane][p] = M[wy * CWIN + wx];
    }
    if (threadIdx.x == 0) {
      j.where[tl] = out_plane | ((k + 1) << 1);
      ++t.abs_run;
      if (s_rounds)                      // the image moved in that round
        atomicMax(j.moved + b, done + 32 - __clz(s_rounds));
    }
    return changed;
  });
}

// A pass over every pixel of every tile, ROWS rows of 32 a thread: fn(q,
// b, y, x, p, valid, c) for the thread's row q, with p the pixel's index in
// the batch and c its component (-1 beyond the image), each warp's lanes on
// one row (invalid lanes still call it: the warp's collectives need every
// lane).  A thread loads its components before it calls fn.
constexpr int ROWS = TILE / (THREADS / 32);

template <class Fn>
__device__ void each_tile_pixel(const Job& j, Fn fn) {
  const int hw = j.H * j.W;
  const int per = j.ty_n * j.tx_n;
  const long long tiles = (long long)j.B * per;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int b = (int)(tl / per), tr = (int)(tl % per);
    const int y0 = (tr / j.tx_n) * TILE + row, x = (tr % j.tx_n) * TILE + lane;
    const int* C = j.comp[ld(j.where + tl) & 1];
    const long long base = (long long)b * hw + x;
    int c[ROWS];
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int y = y0 + q * (THREADS / 32);
      c[q] = y < j.H && x < j.W ? ld(C + base + (long long)y * j.W) : -1;
    }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const int y = y0 + q * (THREADS / 32);
      fn(b, base + (long long)y * j.W, c[q] >= 0, c[q]);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 3)
slic_connectivity_kernel(Job j) {
  __shared__ int s[2 * CWIN2];
  cg::grid_group g = cg::this_grid();
  Tally t;
  t.at = clock_ns();
  const int hw = j.H * j.W;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  const bool enforce = j.max_sweeps > 0;
  const int tiles = j.B * j.ty_n * j.tx_n;

  // 0. Orphans, up to ORPHAN_SWEEPS sweeps a pass; the last pass writes
  // the labels (the others alternate with comp[1], free until the
  // components start) and the same-label bits.
  const int passes = j.absorb_sweeps > 0
                         ? (j.absorb_sweeps + ORPHAN_SWEEPS - 1) / ORPHAN_SWEEPS
                         : 1;
  for (int ps = 0; ps < passes; ++ps) {
    const int sweeps = ps < passes - 1
                           ? ORPHAN_SWEEPS
                           : j.absorb_sweeps - ORPHAN_SWEEPS * (passes - 1);
    const int* src = ps == 0 ? j.in : ((passes - ps) & 1 ? j.comp[1] : j.lab);
    int* dst = (passes - 1 - ps) & 1 ? j.comp[1] : j.lab;
    orphan_pass(j, src, dst, sweeps, enforce && ps == passes - 1, s);
    if (ps == 0 && enforce) {
      for (long long i = tid; i < (long long)j.B * j.k; i += stride)
        j.best[i] = 0u;   // below the ordered bits of every score
      for (long long i = tid; i < tiles; i += stride) j.queued[i] = 0;
    }
    barrier(g, t, 0);
  }

  int blocks = 0, rounds = 0, steps = 0, k = 0, minor = 0;
  if (enforce) {
    // 1. Components, super-block by super-block while a tile is listed.
    const int total = 4 * j.max_sweeps;
    for (; steps < total; ++k) {
      const int n_active = k == 0 ? tiles : ld(j.tcount + k % 3);
      if (n_active == 0) break;
      if (g.thread_rank() == 0) {
        j.tcount[(k + 2) % 3] = 0;       // listed in k + 1, taken in k + 2
        j.tnext[(k + 2) % 3] = 0;
        t.skipped += tiles - n_active;
      }
      const int sb = min(SUPER, total - steps);
      super_block(j, k, steps, sb, n_active, s, t);
      steps += sb;
      barrier(g, t, 1);
    }
    const int super_blocks = k;

    // 2. Sizes: a warp's lanes of one component add together.
    each_tile_pixel(j, [&](int b, long long, bool valid, int c) {
      const unsigned same = __match_any_sync(FULL, c);
      if (valid && (threadIdx.x & 31) == __ffs(same) - 1)
        atomicAdd(j.size + (long long)b * hw + c, __popc(same));
    });
    barrier(g, t, 2);
    // 3. Each label's best score (a component's pixels share its label),
    // then the minor flags.
    each_tile_pixel(j, [&](int b, long long p, bool valid, int c) {
      const unsigned same = __match_any_sync(FULL, c);
      if (!valid || (threadIdx.x & 31) != __ffs(same) - 1) return;
      const int l = ld(j.lab + p);
      if (l >= 0 && l < j.k)
        atomicMax(j.best + (long long)b * j.k + l,
                  ordered(score(ld(j.size + (long long)b * hw + c), hw, c)));
    });
    barrier(g, t, 2);
    each_tile_pixel(j, [&](int b, long long p, bool valid, int c) {
      const unsigned same = __match_any_sync(FULL, c);
      const int lead = __ffs(same) - 1;
      bool flag = false;
      if (valid && (threadIdx.x & 31) == lead) {
        const int l = ld(j.lab + p);
        flag = l >= 0 && l < j.k &&
               ordered(score(ld(j.size + (long long)b * hw + c), hw, c)) <
                   ld(j.best + (long long)b * j.k + l);
      }
      flag = __shfl_sync(FULL, flag, lead) && valid;
      if (valid) j.minor[0][p] = flag;
      const unsigned flags = __ballot_sync(FULL, flag);
      if ((threadIdx.x & 31) == 0) minor += __popc(flags);
    });
    barrier(g, t, 2);

    // 4. Absorption, ABS_ROUNDS rounds a pass while a tile is listed,
    // passes numbered on from the super-blocks' (their lists and stamps).
    for (int a = 0; rounds < j.max_sweeps; ++a) {
      const int kk = super_blocks + a;
      const int n_active = a == 0 ? tiles : ld(j.tcount + kk % 3);
      if (n_active == 0) break;
      if (g.thread_rank() == 0) {
        j.tcount[(kk + 2) % 3] = 0;
        j.tnext[(kk + 2) % 3] = 0;
        t.abs_skipped += tiles - n_active;
        j.tail[CT_ABS_PASSES] = a + 1;
      }
      const int n = min(ABS_ROUNDS, j.max_sweeps - rounds);
      absorb_pass(j, kk, a == 0, rounds, n, n_active, s, t);
      rounds += n;
      barrier(g, t, 3);
    }
    // The tiles whose labels ended in the second plane.
    for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
      if (!(ld(j.where + tl) & 1)) continue;
      const int per = j.ty_n * j.tx_n, tr = (int)(tl % per);
      const long long base = (tl / per) * hw;
      for (int i = threadIdx.x; i < TILE * TILE; i += THREADS) {
        const int y = (tr / j.tx_n) * TILE + i / TILE;
        const int x = (tr % j.tx_n) * TILE + i % TILE;
        if (y < j.H && x < j.W)
          j.lab[base + y * j.W + x] = ld(j.comp[0] + base + y * j.W + x);
      }
    }
    rounds = 0;
    for (int b = 0; b < j.B; ++b) {
      blocks = max(blocks, min(j.max_sweeps, (ld(j.last + b) + 3) / 4 + 1));
      rounds = max(rounds, min(j.max_sweeps, ld(j.moved + b) + 1));
    }
    k = super_blocks;
  }
  if (threadIdx.x == 0) {
    atomicAdd(j.tail + CT_TILES_RUN, t.run);
    atomicAdd(j.tail + CT_ABS_RUN, t.abs_run);
  }
  if ((threadIdx.x & 31) == 0 && minor) atomicAdd(j.tail + CT_MINOR, minor);
  if (g.thread_rank() == 0) {
    j.tail[CT_TILES_SKIPPED] = t.skipped;
    j.tail[CT_ABS_SKIPPED] = t.abs_skipped;
    j.tail[CT_BARRIERS] = t.barriers;
    j.tail[CT_SUPER_BLOCKS] = k;
    j.tail[CT_STEPS] = steps;
    for (int st = 0; st < 4; ++st) j.tail[CT_ORPHAN_NS + st] = (int)t.ns[st];
    j.tail[CT_BLOCKS] = blocks;
    j.tail[CT_ROUNDS] = rounds;
  }
}

__global__ void __launch_bounds__(THREADS) barrier_loop_kernel(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

// The kernel's grid: every block resident at once, as many as fit.
// info (host, 6 ints or null): blocks, resident blocks per SM, registers,
// static shared memory per block, the tile's side, SUPER.
cudaError_t grid_for(int* blocks, int* info) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slic_connectivity_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  if (info) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, slic_connectivity_kernel);
    if (err != cudaSuccess) return err;
    const int v[6] = {*blocks, per_sm, attr.numRegs, (int)attr.sharedSizeBytes,
                      TILE, SUPER};
    for (int i = 0; i < 6; ++i) info[i] = v[i];
  }
  return cudaSuccess;
}

}  // namespace

// Repairs B (H, W) label maps.  `in` and `out` are (B, H, W) int32, labels
// in [0, k) (a label outside it never counts as a label's best, and is not
// minor).  With n = B H W and T = B ceil(H / 32) ceil(W / 32) tiles, `work`
// holds 3 n int32 words (two component planes, the second also the
// absorption's second label plane, and the sizes), B k words (the best
// scores), 4 T int32 words (the tiles' planes and list stamps, two active
// lists), then 3 n bytes (the same-label bits, two planes of minor flags);
// `ctrl` 2 B + 6 + 15 int32, zero; on return its last
// 15 words are the tallies (the super-blocks' tiles run and skipped,
// barriers, super-blocks, Jacobi steps, minor pixels, the absorption
// passes' tiles run and skipped and its passes, four stage times in ns
// with SLIC_CONNECTIVITY_STATS), then the component blocks and absorption
// rounds the plain version runs.  absorb_sweeps orphan sweeps come first;
// max_sweeps 0 skips enforce_connectivity (and k is not read).  Returns a
// CUDA error code (0: launched).
extern "C" int slic_connectivity(int B, int H, int W, int k,
                                 int absorb_sweeps, int max_sweeps,
                                 const void* in, void* out, void* work,
                                 void* ctrl, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)H * W >= (1LL << 24) ||
      (long long)B * H * W >= (1LL << 31) || k < 1 || absorb_sweeps < 0 ||
      max_sweeps < 0 || max_sweeps > (1 << 28))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  Job j;
  j.ty_n = (H + TILE - 1) / TILE;
  j.tx_n = (W + TILE - 1) / TILE;
  const long long tiles = (long long)B * j.ty_n * j.tx_n;
  j.in = (const int*)in;
  j.lab = (int*)out;
  j.comp[0] = (int*)work;
  j.comp[1] = j.comp[0] + n;
  j.size = j.comp[1] + n;
  j.best = (unsigned*)(j.size + n);
  j.where = (int*)(j.best + (long long)B * k);
  j.queued = j.where + tiles;
  j.active[0] = j.queued + tiles;
  j.active[1] = j.active[0] + tiles;
  j.bits = (uint8_t*)(j.active[1] + tiles);
  j.minor[0] = j.bits + n;
  j.minor[1] = j.minor[0] + n;
  int* c = (int*)ctrl;
  j.last = c;
  j.moved = c + B;
  j.tcount = c + 2 * B;
  j.tnext = c + 2 * B + 3;
  j.tail = c + 2 * B + 6;
  j.B = B;
  j.H = H;
  j.W = W;
  j.k = k;
  j.absorb_sweeps = absorb_sweeps;
  j.max_sweeps = max_sweeps;

  int blocks = 0;
  cudaError_t err = grid_for(&blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&j};
  err = cudaLaunchCooperativeKernel((const void*)slic_connectivity_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's grid (see grid_for); returns a CUDA error code.
extern "C" int slic_connectivity_grid(int* info) {
  int blocks = 0;
  return (int)grid_for(&blocks, info);
}

// `n` empty grid-wide barriers on the kernel's grid: its barrier floor.
extern "C" int slic_connectivity_barriers(int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_for(&blocks, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel,
                                    dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
