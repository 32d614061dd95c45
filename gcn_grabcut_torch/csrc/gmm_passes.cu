// GrabCut's colour models for Hopper (sm_90a): the seeded k-means, the GMM
// fits, the component scores and the terminal energy as passes over the
// pixels, each reading them once, with every per-component intermediate
// kept in registers or shared memory.
//
// Replaces no Pallas kernel.  In the JAX package these steps are XLA code
// (gcn_grabcut_tpu/ops/gmm.py: kmeans, fit_gmm, component_scores,
// assign_components, gmm_log_prob, as masked dense reductions that XLA
// fuses).  Eager PyTorch runs them as float64 cuBLAS GEMMs with one 32 x 32
// output tile an image, ~20 elementwise passes over (B, H, W, k) a score,
// and a pageable upload of the k-means++ noise a draw: ~1 500 launches a
// lock-step solve (ops/gmm.py's plain functions, which stay the oracle).
//
// What it computes: the plain functions' results bit for bit, for B
// same-size images of 3-channel float32 pixels with a class plane (a
// trimap, or a foreground flag: 1 and 3 are foreground, anything else
// background), k components a class.  Both classes go through every pass.
//   SEED      the first k-means++ centre of each class: its first pixel
//             (argmax of the 0 / 1 class weight, ties to the lowest index);
//   DRAW i    centre i + 1: argmax over the pixels of log(max(w d2, 1e-30))
//             plus the class's Gumbel noise of draw i, d2 the squared
//             distance to the nearest chosen centre;
//   LLOYD     each pixel's nearest centre of its class, the count and sum
//             of x per (class, component); the last block then moves each
//             centre to its mean (kept where the count is 0);
//   LABELS    each pixel's nearest centre of its class (int64 labels);
//   FIT       the count and the sums of x and x x^T per (class, component)
//             of given labels; the last block then fits both GMMs;
//   ASSIGN    each pixel's best component under its class's GMM (cv2's
//             assignGMMsComponents; written only when asked), then FIT's
//             sums and fits on those components (the next GMMs);
//   TERMINAL  each mixture's log-sum-exp floored at -80, the difference
//             clamped to +-lambda, E_t from the trimap (lambda at FG,
//             -lambda at BG) and the excess e_carry + (E_t - E_prev).
// Every float32 step keeps the plain version's operation order with no FMA
// contraction (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn; adds of +0
// included), expf and logf are the CUDA math library's, as PyTorch's, and
// argmax / argmin keep torch's rule (the first extreme; a NaN wins).  Sums
// over pixels are float64 and rounded once to float32: for RGB the addends
// are integers and every order is exact; in any colour space a thread adds
// its pixels in index order into its own slots, a block adds its threads'
// slots in a fixed tree, and the last block adds the blocks' partials in a
// fixed order, so a run repeats to the bit.
//
// Bound.  Bytes, at 3.35 TB/s on an H100: each pass reads the pixels (12
// bytes) and the class plane (1 byte) once; DRAW adds two noise planes (8),
// LABELS writes and FIT reads the labels (8), TERMINAL reads e_carry and
// E_prev and writes E_t and the excess (16).  A lock-step solve (k = 5, 10
// Lloyd steps, 5 iterations) is 27 passes, ~475 bytes a pixel: ~0.04 ms
// for 8 images of 512^2 and ~0.33 ms for one of 1536^2.
//
// Design.  A launch is (chunks, B) blocks of 128 threads, a block a
// contiguous chunk of one image's pixels, the grid sized from B H W
// (gmm_grid: ~2 blocks a SM for the passes that sum moments, ~8 for the
// others).  A summing pass keeps one float64 slot per thread,
// (class, component) and moment in shared memory (10 moments for a fit: a
// count, 3 sums, 6 products of x x^T's upper triangle), as many
// (class, component) pairs a round as ~110 KB hold (all 10 at k = 5: one
// round; a larger k loops over rounds, reading the chunk again).  Argmax
// passes keep a (value, index) pair a thread and class.  Each block writes
// its partials; the last block of an image to arrive (an atomic count, with
// fences) adds the image's partials, derives what the next pass reads (the
// centres, or both GMMs: means, covariance with the two COV_REG steps, the
// closed-form inverse and log_norm, in fit_gmm's float32 order) into the
// image's model, and resets the count.  The k-means++ noise is uploaded once
// per shape by the wrapper.  This file owns the layout: the wrapper sizes
// the model and the partials, and reads the model's fields, through
// gmm_model_size, gmm_model_field and gmm_grid, and gmm_pass refuses
// buffers too small for the pass.  The wrapper allocates every buffer; the
// kernel allocates nothing and does not synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SLOT_BYTES = 110 * 1024;   // a summing block's float64 slots
constexpr int MAX_SMEM = 232448;         // a block's shared memory on sm_90
constexpr int MAX_DEVICES = 64;

enum Kind { K_SEED, K_DRAW, K_LLOYD, K_LABELS, K_FIT, K_ASSIGN, K_TERMINAL,
            K_COUNT };

constexpr int LLOYD_MOM = 4;   // count, x0, x1, x2
constexpr int FIT_MOM = 10;    // and x0x0, x0x1, x0x2, x1x1, x1x2, x2x2

// fit_gmm's constants, rounded from their float64 values as torch rounds a
// Python scalar for a float32 tensor.
constexpr double COV_REG = 0.01;
constexpr double DET_EPS = 1e-6;
constexpr double W_FLOOR = 1e-30;
constexpr float LOG_FLOOR = -80.0f;

struct Pass {
  int kind, HW, k, chunks, chunk_px, step, group;
  const float* pix;        // (B, HW, 3)
  const uint8_t* cls;      // (B, HW): 1 or 3 foreground, else background
  const int64_t* comp_in;  // FIT: (B, HW) labels
  int64_t* comp_out;       // LABELS, ASSIGN (may be null): (B, HW)
  const float* noise_fg;   // DRAW: (draws, HW) each
  const float* noise_bg;
  float* model;            // (B, model_size(k))
  double* partial;         // (B, chunks, partials a block)
  unsigned* arrivals;      // (B), 0 between launches
  const float* e_carry;    // TERMINAL: (B, HW), with e_prev and excess
  const float* e_prev;     //   null where no excess is asked for
  float* e_t;
  float* excess;
  float lam;
};

// An image's model: the centres [2][k][3], then per class c (0 foreground,
// 1 background) its total, and per component the rounded sums (count,
// x, x x^T), then the fitted weight, mean, inverse covariance, determinant
// and log_norm.  gmm_model_field hands the wrapper the same offsets.
struct Layout {
  int k;
  __host__ __device__ int size() const { return 6 * k + 2 * (1 + 28 * k); }
  __host__ __device__ int centre(int c, int j) const {
    return (c * k + j) * 3;
  }
  __host__ __device__ int base(int c) const {
    return 6 * k + c * (1 + 28 * k);
  }
  __host__ __device__ int total(int c) const { return base(c); }
  __host__ __device__ int cnt(int c, int j) const { return base(c) + 1 + j; }
  __host__ __device__ int sx(int c, int j) const {
    return base(c) + 1 + k + 3 * j;
  }
  __host__ __device__ int sxx(int c, int j) const {
    return base(c) + 1 + 4 * k + 9 * j;
  }
  __host__ __device__ int weight(int c, int j) const {
    return base(c) + 1 + 13 * k + j;
  }
  __host__ __device__ int mean(int c, int j) const {
    return base(c) + 1 + 14 * k + 3 * j;
  }
  __host__ __device__ int inv(int c, int j) const {
    return base(c) + 1 + 17 * k + 9 * j;
  }
  __host__ __device__ int det(int c, int j) const {
    return base(c) + 1 + 26 * k + j;
  }
  __host__ __device__ int lnorm(int c, int j) const {
    return base(c) + 1 + 27 * k + j;
  }
};

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ bool nan_(float x) { return x != x; }

// torch's clamp_min / clamp on float32: a NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return nan_(v) ? v : (v < lo ? lo : v);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return nan_(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Class 0 is foreground (trimap FG or PR_FG, or a set flag), 1 background.
__device__ __forceinline__ int class_of(uint8_t v) {
  return (v == 1 || v == 3) ? 0 : 1;
}

// Whether (a, ia) is torch's argmax over (b, ib): a NaN wins, ties go to
// the lower index; an index below 0 is no entry.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (ib < 0) return true;
  if (ia < 0) return false;
  if (nan_(a)) return nan_(b) ? ia < ib : true;
  if (nan_(b)) return false;
  return a == b ? ia < ib : a > b;
}

// _sq_dist: the channels' squares added in order.
__device__ __forceinline__ float sq_dist(const float x[3], const float* c) {
  const float d0 = fsub(x[0], c[0]), d1 = fsub(x[1], c[1]),
              d2 = fsub(x[2], c[2]);
  return fadd(fadd(fmul(d0, d0), fmul(d1, d1)), fmul(d2, d2));
}

// argmin over the k centres at `c` (torch.argmin: the first minimum, a NaN
// wins).
__device__ __forceinline__ int nearest(const float x[3], const float* c,
                                       int k) {
  float best = sq_dist(x, c);
  int bj = 0;
  for (int j = 1; j < k; ++j) {
    const float v = sq_dist(x, c + 3 * j);
    if (!nan_(best) && (nan_(v) || v < best)) {
      best = v;
      bj = j;
    }
  }
  return bj;
}

// component_scores for one component: log_norm - 0.5 d^T A d, the
// quadratic form's adds in the plain version's order.
__device__ __forceinline__ float score(const float x[3], const float* mean,
                                       const float* inv, float lnorm) {
  const float d[3] = {fsub(x[0], mean[0]), fsub(x[1], mean[1]),
                      fsub(x[2], mean[2])};
  float maha = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float t = fmul(d[0], inv[j]);
    t = fadd(t, fmul(d[1], inv[3 + j]));
    t = fadd(t, fmul(d[2], inv[6 + j]));
    maha = j == 0 ? fmul(t, d[0]) : fadd(maha, fmul(t, d[j]));
  }
  return fsub(lnorm, fmul(0.5f, maha));
}

__device__ __forceinline__ float comp_score(const float x[3], const float* m,
                                            const Layout& L, int c, int j) {
  return score(x, m + L.mean(c, j), m + L.inv(c, j), m[L.lnorm(c, j)]);
}

// assign_components: argmax of the scores under class c's GMM.
__device__ __forceinline__ int best_component(const float x[3],
                                              const float* m,
                                              const Layout& L, int c) {
  float best = comp_score(x, m, L, c, 0);
  int bj = 0;
  for (int j = 1; j < L.k; ++j) {
    const float v = comp_score(x, m, L, c, j);
    if (!nan_(best) && (nan_(v) || v > best)) {
      best = v;
      bj = j;
    }
  }
  return bj;
}

// gmm_log_prob: peak + log(sum of exp(score - peak)), the exps added in
// component order, floored at LOG_FLOOR.  The scores are computed twice
// (for the peak, then for the sum), bit for bit alike.
__device__ __forceinline__ float log_prob(const float x[3], const float* m,
                                          const Layout& L, int c) {
  float peak = comp_score(x, m, L, c, 0);
  for (int j = 1; j < L.k; ++j) {
    const float v = comp_score(x, m, L, c, j);
    if (!(nan_(peak) || peak > v)) peak = v;
  }
  float sum = 0.0f;
  for (int j = 0; j < L.k; ++j) {
    const float e = expf(fsub(comp_score(x, m, L, c, j), peak));
    sum = j == 0 ? e : fadd(sum, e);
  }
  return clamp_min(fadd(peak, logf(sum)), LOG_FLOOR);
}

// ops/gmm.py _inv3: the adjugate over max(det, DET_EPS), and det.
__device__ void inv3(const float* M, float* inv, float* det_out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5],
              g = M[6], h = M[7], i = M[8];
  const float A = fsub(fmul(e, i), fmul(f, h));
  const float B = -fsub(fmul(d, i), fmul(f, g));
  const float C = fsub(fmul(d, h), fmul(e, g));
  const float det = fadd(fadd(fmul(a, A), fmul(b, B)), fmul(c, C));
  const float adj[9] = {A, -fsub(fmul(b, i), fmul(c, h)),
                        fsub(fmul(b, f), fmul(c, e)),
                        B, fsub(fmul(a, i), fmul(c, g)),
                        -fsub(fmul(a, f), fmul(c, d)),
                        C, -fsub(fmul(a, h), fmul(b, g)),
                        fsub(fmul(a, e), fmul(b, d))};
  const float den = clamp_min(det, (float)DET_EPS);
  for (int n = 0; n < 9; ++n) inv[n] = fdiv(adj[n], den);
  *det_out = det;
}

// Which of FIT_MOM's moments holds x x^T's entry (i, j).
__device__ __forceinline__ int sym(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return 4 + (lo == 0 ? hi : (lo == 1 ? 2 + hi : 5));
}

// fit_gmm for class c's component j from the image's float64 sums `r`
// (FIT_MOM of them) and the class's pixel count `total64`, into the model.
__device__ void fit_component(float* m, const Layout& L, int c, int j,
                              const double* r, double total64) {
  const float cnt = (float)__ldcg(r);
  const float total = clamp_min((float)total64, 1.0f);
  const float c1 = clamp_min(cnt, 1.0f);
  float mean[3], cov[9], inv[9], det;
  for (int i = 0; i < 3; ++i) {
    const float s = (float)__ldcg(r + 1 + i);
    m[L.sx(c, j) + i] = s;
    mean[i] = fdiv(s, c1);
  }
  for (int i = 0; i < 3; ++i)
    for (int jj = 0; jj < 3; ++jj) {
      const float s = (float)__ldcg(r + sym(i, jj));
      m[L.sxx(c, j) + 3 * i + jj] = s;
      cov[3 * i + jj] = fsub(fdiv(s, c1), fmul(mean[i], mean[jj]));
    }
  for (int rep = 0; rep < 2; ++rep) {
    inv3(cov, inv, &det);
    const bool low = det < (float)DET_EPS;
    for (int n = 0; n < 9; ++n)
      cov[n] = fadd(cov[n], (low && n % 4 == 0) ? (float)COV_REG : 0.0f);
  }
  inv3(cov, inv, &det);
  const float w = fdiv(cnt, total);
  const float ln = cnt > 0.0f
      ? fsub(logf(clamp_min(w, (float)W_FLOOR)),
             fmul(0.5f, logf(clamp_min(det, (float)DET_EPS))))
      : LOG_FLOOR;
  m[L.cnt(c, j)] = cnt;
  if (j == 0) m[L.total(c)] = total;
  m[L.weight(c, j)] = w;
  for (int i = 0; i < 3; ++i) m[L.mean(c, j) + i] = mean[i];
  for (int n = 0; n < 9; ++n) m[L.inv(c, j) + n] = inv[n];
  m[L.det(c, j)] = det;
  m[L.lnorm(c, j)] = ln;
}

// Whether this block is its image's last to arrive; its partials are
// published first (threadFenceReduction's pattern).
__device__ bool arrive_last(const Pass& P) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(P.arrivals + blockIdx.y, 1u);
    last = prev == (unsigned)(P.chunks - 1);
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

__device__ __forceinline__ void load_pixel(const Pass& P, long long q,
                                           float x[3]) {
  x[0] = P.pix[3 * q];
  x[1] = P.pix[3 * q + 1];
  x[2] = P.pix[3 * q + 2];
}

// SEED and DRAW: a (value, index) pair a class, reduced over the block,
// then over the image's blocks by the last one, which writes the centre.
__device__ void argmax_pass(const Pass& P, float* sval, int* sidx) {
  const int tid = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x;
  const Layout L{P.k};
  const long long img = (long long)b * P.HW;
  float* m = P.model + (long long)b * L.size();
  const int start = chunk * P.chunk_px;
  const int end = min(P.HW, start + P.chunk_px);
  float bv[2] = {0.0f, 0.0f};
  int bi[2] = {-1, -1};
  const float* noise[2] = {P.noise_fg, P.noise_bg};
  for (int p = start + tid; p < end; p += THREADS) {
    const long long q = img + p;
    const int own = class_of(P.cls[q]);
    float x[3];
    if (P.kind == K_DRAW) load_pixel(P, q, x);
    for (int c = 0; c < 2; ++c) {
      const float w = own == c ? 1.0f : 0.0f;
      float v = w;
      if (P.kind == K_DRAW) {
        float d2 = sq_dist(x, m + L.centre(c, 0));
        for (int j = 1; j <= P.step; ++j) {
          const float s = sq_dist(x, m + L.centre(c, j));
          if (!nan_(d2) && (nan_(s) || s < d2)) d2 = s;
        }
        v = fadd(logf(clamp_min(fmul(w, d2), (float)W_FLOOR)),
                 noise[c][(long long)P.step * P.HW + p]);
      }
      if (better(v, p, bv[c], bi[c])) {
        bv[c] = v;
        bi[c] = p;
      }
    }
  }
  for (int round = 0; round < 2; ++round) {
    // Round 0 reduces the block's threads; round 1 (the last block only)
    // the image's blocks, each thread over chunks tid, tid + THREADS, ...
    for (int c = 0; c < 2; ++c) {
      sval[c * THREADS + tid] = bv[c];
      sidx[c * THREADS + tid] = bi[c];
    }
    __syncthreads();
    for (int h = THREADS / 2; h > 0; h >>= 1) {
      if (tid < h)
        for (int c = 0; c < 2; ++c) {
          const int o = c * THREADS + tid;
          if (better(sval[o + h], sidx[o + h], sval[o], sidx[o])) {
            sval[o] = sval[o + h];
            sidx[o] = sidx[o + h];
          }
        }
      __syncthreads();
    }
    if (round == 1) break;
    double* part = P.partial + ((long long)b * P.chunks + chunk) * 4;
    if (tid == 0)
      for (int c = 0; c < 2; ++c) {
        part[2 * c] = (double)sval[c * THREADS];
        part[2 * c + 1] = (double)sidx[c * THREADS];
      }
    if (!arrive_last(P)) return;
    bi[0] = bi[1] = -1;
    const double* all = P.partial + (long long)b * P.chunks * 4;
    for (int ch = tid; ch < P.chunks; ch += THREADS)
      for (int c = 0; c < 2; ++c) {
        const float v = (float)__ldcg(all + 4 * ch + 2 * c);
        const int i = (int)__ldcg(all + 4 * ch + 2 * c + 1);
        if (better(v, i, bv[c], bi[c])) {
          bv[c] = v;
          bi[c] = i;
        }
      }
    __syncthreads();
  }
  if (tid < 2) {
    const int c = tid, n = P.kind == K_SEED ? 0 : P.step + 1;
    const long long q = img + sidx[c * THREADS];
    for (int i = 0; i < 3; ++i) m[L.centre(c, n) + i] = P.pix[3 * q + i];
  }
  if (tid == 0) P.arrivals[b] = 0;
}

// LLOYD, FIT and ASSIGN: MOM float64 moments per (class, component), in
// rounds of P.group pairs; the last block adds the image's partials and
// derives the centres (LLOYD) or both GMMs (FIT, ASSIGN).
template <int MOM>
__device__ void sum_pass(const Pass& P, double* slots, int cap) {
  const int tid = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x;
  const Layout L{P.k};
  const int combos = 2 * P.k, O = combos * MOM, G = P.group;
  const long long img = (long long)b * P.HW;
  float* m = P.model + (long long)b * L.size();
  const int start = chunk * P.chunk_px;
  const int end = min(P.HW, start + P.chunk_px);
  double* part = P.partial + ((long long)b * P.chunks + chunk) * O;
  for (int g0 = 0; g0 < combos; g0 += G) {
    const int ng = min(G, combos - g0);
    for (int i = tid; i < ng * MOM * THREADS; i += THREADS) slots[i] = 0.0;
    __syncthreads();
    for (int p = start + tid; p < end; p += THREADS) {
      const long long q = img + p;
      float x[3];
      load_pixel(P, q, x);
      const int c = class_of(P.cls[q]);
      int j;
      if (P.kind == K_LLOYD) {
        j = nearest(x, m + L.centre(c, 0), P.k);
      } else if (P.kind == K_FIT) {
        const long long v = P.comp_in[q];
        if (v < 0 || v >= P.k) continue;
        j = (int)v;
      } else {
        j = best_component(x, m, L, c);
        if (g0 == 0 && P.comp_out) P.comp_out[q] = j;
      }
      const int g = c * P.k + j - g0;
      if (g < 0 || g >= ng) continue;
      double* s = slots + g * MOM * THREADS + tid;
      s[0] = __dadd_rn(s[0], 1.0);
      for (int i = 0; i < 3; ++i)
        s[(1 + i) * THREADS] = __dadd_rn(s[(1 + i) * THREADS], (double)x[i]);
      if (MOM == FIT_MOM) {
        int n = 4;
        for (int i = 0; i < 3; ++i)
          for (int jj = i; jj < 3; ++jj, ++n)
            s[n * THREADS] = __dadd_rn(s[n * THREADS],
                                       (double)fmul(x[i], x[jj]));
      }
    }
    __syncthreads();
    const int outs = ng * MOM;
    for (int h = THREADS / 2; h > 0; h >>= 1) {
      for (int i = tid; i < outs * h; i += THREADS) {
        const int o = i / h, t = i - o * h;
        slots[o * THREADS + t] = __dadd_rn(slots[o * THREADS + t],
                                           slots[o * THREADS + t + h]);
      }
      __syncthreads();
    }
    for (int o = tid; o < outs; o += THREADS)
      part[g0 * MOM + o] = slots[o * THREADS];
    __syncthreads();
  }
  if (!arrive_last(P)) return;

  // The image's sums into chunk 0's row: S strided runs of the chunks a
  // column in shared memory, then the runs in order (S = 1 straight from
  // the partials where shared memory cannot hold a row of them).
  double* all = P.partial + (long long)b * P.chunks * O;
  const int S = min(P.chunks, cap / O);
  if (S >= 1) {
    for (int i = tid; i < O * S; i += THREADS) {
      const int s = i / O, o = i - s * O;
      double acc = 0.0;
      for (int ch = s; ch < P.chunks; ch += S)
        acc = __dadd_rn(acc, __ldcg(all + (long long)ch * O + o));
      slots[i] = acc;
    }
    __syncthreads();
    for (int o = tid; o < O; o += THREADS) {
      double acc = slots[o];
      for (int s = 1; s < S; ++s) acc = __dadd_rn(acc, slots[s * O + o]);
      all[o] = acc;
    }
  } else {
    for (int o = tid; o < O; o += THREADS) {
      double acc = 0.0;
      for (int ch = 0; ch < P.chunks; ++ch)
        acc = __dadd_rn(acc, __ldcg(all + (long long)ch * O + o));
      all[o] = acc;
    }
  }
  __threadfence_block();
  __syncthreads();
  for (int t = tid; t < combos; t += THREADS) {
    const int c = t / P.k, j = t - c * P.k;
    const double* r = all + t * MOM;
    if (P.kind == K_LLOYD) {
      // kmeans: tot / max(cnt, 1e-6) where cnt > 0.
      const float cnt = (float)__ldcg(r);
      if (cnt > 0.0f) {
        const float den = clamp_min(cnt, (float)DET_EPS);
        for (int i = 0; i < 3; ++i)
          m[L.centre(c, j) + i] = fdiv((float)__ldcg(r + 1 + i), den);
      }
    } else {
      double total = 0.0;   // the class's pixels: an exact integer
      for (int jj = 0; jj < P.k; ++jj)
        total = __dadd_rn(total, __ldcg(all + (c * P.k + jj) * MOM));
      fit_component(m, L, c, j, r, total);
    }
  }
  if (tid == 0) P.arrivals[b] = 0;
}

__device__ void labels_pass(const Pass& P) {
  const Layout L{P.k};
  const int b = blockIdx.y;
  const long long img = (long long)b * P.HW;
  const float* m = P.model + (long long)b * L.size();
  const int start = blockIdx.x * P.chunk_px;
  const int end = min(P.HW, start + P.chunk_px);
  for (int p = start + threadIdx.x; p < end; p += THREADS) {
    const long long q = img + p;
    float x[3];
    load_pixel(P, q, x);
    P.comp_out[q] = nearest(x, m + L.centre(class_of(P.cls[q]), 0), P.k);
  }
}

__device__ void terminal_pass(const Pass& P) {
  const Layout L{P.k};
  const int b = blockIdx.y;
  const long long img = (long long)b * P.HW;
  const float* m = P.model + (long long)b * L.size();
  const int start = blockIdx.x * P.chunk_px;
  const int end = min(P.HW, start + P.chunk_px);
  for (int p = start + threadIdx.x; p < end; p += THREADS) {
    const long long q = img + p;
    float x[3];
    load_pixel(P, q, x);
    const float unknown = clamp(fsub(log_prob(x, m, L, 0),
                                     log_prob(x, m, L, 1)),
                                -P.lam, P.lam);
    const uint8_t t = P.cls[q];
    const float et = t == 1 ? P.lam : (t == 0 ? -P.lam : unknown);
    P.e_t[q] = et;
    if (P.excess) P.excess[q] = fadd(P.e_carry[q], fsub(et, P.e_prev[q]));
  }
}

__global__ void __launch_bounds__(THREADS) gmm_pass_kernel(const Pass P,
                                                           int cap) {
  extern __shared__ double smem[];
  switch (P.kind) {
    case K_SEED:
    case K_DRAW:
      argmax_pass(P, (float*)smem, (int*)((float*)smem + 2 * THREADS));
      break;
    case K_LLOYD:
      sum_pass<LLOYD_MOM>(P, smem, cap);
      break;
    case K_FIT:
    case K_ASSIGN:
      sum_pass<FIT_MOM>(P, smem, cap);
      break;
    case K_LABELS:
      labels_pass(P);
      break;
    default:
      terminal_pass(P);
  }
}

int moments(int kind) {
  return kind == K_LLOYD ? LLOYD_MOM
       : (kind == K_FIT || kind == K_ASSIGN) ? FIT_MOM : 0;
}

// float64 partials a block of `kind` writes: a (value, index) pair a class
// for the argmax passes, a moment a (class, component) for the summing
// ones, none for the others.
long long partials_per_block(int kind, int k) {
  if (kind == K_SEED || kind == K_DRAW) return 4;
  return 2LL * k * moments(kind);
}

// Blocks a SM a pass aims at: the summing passes hold ~110 KB of slots a
// block, two to a SM; the others read and write only.
int blocks_per_sm(int kind) { return moments(kind) ? 2 : 8; }

}  // namespace

// An image's model size in floats (Layout).
extern "C" int gmm_model_size(int k) { return Layout{k}.size(); }

// Field f of an image's model with k components a class: 0 the centres
// (2, k, 3), then for class c (0 foreground, 1 background) fields
// 1 + 9 c + n, n in order: the total (1), the counts (k), the sums of x
// (k, 3) and of x x^T (k, 3, 3), the weights (k), the means (k, 3), the
// inverse covariances (k, 3, 3), the determinants (k) and the log_norms
// (k).  Writes its offset and its size in floats; returns 0, or -1 where
// there is no field f.
extern "C" int gmm_model_field(int k, int f, int* offset, int* size) {
  const Layout L{k};
  if (k < 1 || f < 0 || f > 18) return -1;
  if (f == 0) {
    *offset = L.centre(0, 0);
    *size = 6 * k;
    return 0;
  }
  const int c = (f - 1) / 9, n = (f - 1) % 9;
  const int offsets[9] = {L.total(c), L.cnt(c, 0), L.sx(c, 0), L.sxx(c, 0),
                          L.weight(c, 0), L.mean(c, 0), L.inv(c, 0),
                          L.det(c, 0), L.lnorm(c, 0)};
  const int sizes[9] = {1, k, 3 * k, 9 * k, k, 3 * k, 9 * k, k, k};
  *offset = offsets[n];
  *size = sizes[n];
  return 0;
}

// The grid of a pass of `kind` over B images of HW pixels, k components a
// class, on a card of `sms` SMs: returns the blocks an image (about
// blocks_per_sm a SM over the batch's B images, at least one, no more than
// one a THREADS pixels; so the grid follows B H W, not B or H W alone) and
// writes the float64 partials the batch's blocks need to *partials.
// Returns -1 for a kind or shape no pass takes.
extern "C" int gmm_grid(int kind, int B, int HW, int k, int sms,
                        long long* partials) {
  if (kind < 0 || kind >= K_COUNT || B < 1 || HW < 1 || k < 1 || sms < 1)
    return -1;
  const long long want = ((long long)blocks_per_sm(kind) * sms + B - 1) / B;
  const long long most = ((long long)HW + THREADS - 1) / THREADS;
  const int chunks = (int)(want < most ? want : most);
  *partials = (long long)B * chunks * partials_per_block(kind, k);
  return chunks;
}

// One pass of `kind` over B images of HW pixels, k components a class, on
// (chunks, B) blocks, on `stream`.  Pointers the pass does not use may be
// null.  `model_len` (floats) and `partial_len` (doubles) are the sizes of
// the model and partial buffers; a pass they cannot hold is refused.
// Returns a CUDA error code (0: launched).
extern "C" int gmm_pass(int kind, int B, int HW, int k, int chunks, int step,
                        int draws, const void* pix, const void* cls,
                        const void* comp_in, void* comp_out,
                        const void* noise_fg, const void* noise_bg,
                        void* model, void* partial, void* arrivals,
                        const void* e_carry, const void* e_prev, void* e_t,
                        void* excess, float lam, long long model_len,
                        long long partial_len, void* stream) {
  if (kind < 0 || kind >= K_COUNT || B < 1 || B > 65535 || HW < 1 ||
      k < 1 || k > 255 * 255 || chunks < 1 || chunks > HW ||
      step < 0 || (kind == K_DRAW && (step >= draws || step >= k - 1)) ||
      model_len < (long long)B * Layout{k}.size() ||
      partial_len < (long long)B * chunks * partials_per_block(kind, k))
    return (int)cudaErrorInvalidValue;
  Pass P;
  P.kind = kind;
  P.HW = HW;
  P.k = k;
  P.chunks = chunks;
  P.chunk_px = (HW + chunks - 1) / chunks;
  P.step = step;
  P.pix = (const float*)pix;
  P.cls = (const uint8_t*)cls;
  P.comp_in = (const int64_t*)comp_in;
  P.comp_out = (int64_t*)comp_out;
  P.noise_fg = (const float*)noise_fg;
  P.noise_bg = (const float*)noise_bg;
  P.model = (float*)model;
  P.partial = (double*)partial;
  P.arrivals = (unsigned*)arrivals;
  P.e_carry = (const float*)e_carry;
  P.e_prev = (const float*)e_prev;
  P.e_t = (float*)e_t;
  P.excess = (float*)excess;
  P.lam = lam;

  // A summing pass's slots: `group` (class, component) pairs a round.
  const int mom = moments(kind);
  size_t smem = 0;
  int cap = 0;
  if (mom) {
    const int fit = SLOT_BYTES / (mom * THREADS * 8);
    P.group = fit < 2 * k ? fit : 2 * k;
    cap = P.group * mom * THREADS;
    smem = (size_t)cap * 8;
  } else if (kind == K_SEED || kind == K_DRAW) {
    P.group = 0;
    smem = 2 * THREADS * (sizeof(float) + sizeof(int));
  } else {
    P.group = 0;
  }
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(gmm_pass_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SLOT_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  gmm_pass_kernel<<<dim3(chunks, B), THREADS, smem, (cudaStream_t)stream>>>(
      P, cap);
  return (int)cudaGetLastError();
}
