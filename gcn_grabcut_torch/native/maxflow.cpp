// Host-side s-t min-cut on a 4/8-connected pixel lattice.
//
// FIFO push-relabel with periodic global relabeling (BFS distance-to-sink)
// and a gap heuristic — the host counterpart of the device's parallel
// push-relabel (ops/maxflow.py), playing the role OpenCV's C++
// Boykov-Kolmogorov solver plays inside cv2.grabCut.  A copy of
// gcn_grabcut_tpu/native/maxflow.cpp with the same C ABI.
//
// Graph encoding matches the device solver: per-pixel signed `excess`
// (cap_source - cap_sink, the shared minimum pre-saturated) and one
// undirected capacity per lattice direction:
//   dir 0: W (0,-1)   dir 1: N (-1,0)   dir 2: NW (-1,-1)   dir 3: NE (-1,+1)
// (4-connectivity uses dirs 0-1 only.)
//
// Exported C ABI (ctypes):
//   void grid_mincut(int H, int W, int connectivity,
//                    const float* excess, const float* caps,  // [ndir][H*W]
//                    unsigned char* out_fg);                  // [H*W]
// out_fg[i] = 1 iff pixel i is on the SOURCE (foreground) side.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Solver {
  int H, W, n, ndir;
  // residual[d][i]  : residual capacity i -> neighbour(i, d)
  // rresidual[d][i] : residual capacity neighbour(i, d) -> i
  std::vector<std::vector<double>> residual, rresidual;
  std::vector<double> excess;     // positive part (source surplus)
  std::vector<double> to_sink;    // residual capacity i -> t
  std::vector<int> height;
  std::vector<int> count_h;       // #nodes at each height (gap heuristic)
  std::queue<int> active;
  std::vector<uint8_t> in_queue;

  static const int DY[4], DX[4];

  Solver(int H_, int W_, int connectivity, const float* exc,
         const float* caps)
      : H(H_), W(W_), n(H_ * W_), ndir(connectivity == 8 ? 4 : 2) {
    residual.assign(ndir, std::vector<double>(n, 0.0));
    rresidual.assign(ndir, std::vector<double>(n, 0.0));
    excess.assign(n, 0.0);
    to_sink.assign(n, 0.0);
    height.assign(n, 0);
    in_queue.assign(n, 0);

    for (int i = 0; i < n; ++i) {
      double e = exc[i];
      if (e > 0) excess[i] = e;
      else to_sink[i] = -e;
    }
    for (int d = 0; d < ndir; ++d) {
      const float* c = caps + (size_t)d * n;
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          int i = y * W + x;
          int qy = y + DY[d], qx = x + DX[d];
          if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
          residual[d][i] = c[i];
          rresidual[d][i] = c[i];
        }
    }
  }

  inline int nbr(int i, int d) const {
    int y = i / W + DY[d], x = i % W + DX[d];
    if (y < 0 || y >= H || x < 0 || x >= W) return -1;
    return y * W + x;
  }

  // BFS distance to the sink along *residual* arcs; unreachable = n.
  void global_relabel() {
    std::fill(height.begin(), height.end(), n);
    std::queue<int> q;
    for (int i = 0; i < n; ++i)
      if (to_sink[i] > 0) { height[i] = 1; q.push(i); }
    // Height 0 is the virtual sink itself; level-1 nodes feed it.
    while (!q.empty()) {
      int j = q.front(); q.pop();
      // incoming arcs i -> j:
      for (int d = 0; d < ndir; ++d) {
        int i = nbr(j, d);         // j's forward neighbour i: arc j->i has
        if (i >= 0 && rresidual[d][j] > 0 && height[i] == n) {
          // arc i->j is the reverse of j's dir-d arc: residual is
          // rresidual[d][j]... careful: rresidual[d][j] is capacity
          // nbr(j,d)=i -> j. Yes: i -> j usable.
          height[i] = height[j] + 1;
          q.push(i);
        }
        // arcs from the node whose dir-d neighbour is j: p with nbr(p,d)==j
        int py = j / W - DY[d], px = j % W - DX[d];
        if (py >= 0 && py < H && px >= 0 && px < W) {
          int p = py * W + px;
          if (residual[d][p] > 0 && height[p] == n) {
            height[p] = height[j] + 1;
            q.push(p);
          }
        }
      }
    }
    count_h.assign(n + 1, 0);
    for (int i = 0; i < n; ++i)
      if (height[i] < n) count_h[height[i]]++;
    while (!active.empty()) active.pop();
    std::fill(in_queue.begin(), in_queue.end(), 0);
    for (int i = 0; i < n; ++i)
      if (excess[i] > 0 && height[i] < n) { active.push(i); in_queue[i] = 1; }
  }

  inline void enqueue(int i) {
    if (!in_queue[i] && excess[i] > 0 && height[i] < n) {
      active.push(i);
      in_queue[i] = 1;
    }
  }

  void discharge(int i) {
    while (excess[i] > 0) {
      if (height[i] == 1 && to_sink[i] > 0) {
        double f = std::min(excess[i], to_sink[i]);
        excess[i] -= f;
        to_sink[i] -= f;
        continue;
      }
      int min_h = n;
      bool pushed = false;
      for (int d = 0; d < ndir && excess[i] > 0; ++d) {
        int j = nbr(i, d);   // forward arc i -> j
        if (j >= 0 && residual[d][i] > 0) {
          if (height[i] == height[j] + 1) {
            double f = std::min(excess[i], residual[d][i]);
            residual[d][i] -= f; rresidual[d][i] += f;
            excess[i] -= f; excess[j] += f;
            enqueue(j);
            pushed = true;
          } else if (height[j] + 1 < min_h) min_h = height[j] + 1;
        }
        // reverse arc i -> p where nbr(p, d) == i
        int py = i / W - DY[d], px = i % W - DX[d];
        if (py >= 0 && py < H && px >= 0 && px < W && excess[i] > 0) {
          int p = py * W + px;
          if (rresidual[d][p] > 0) {
            if (height[i] == height[p] + 1) {
              double f = std::min(excess[i], rresidual[d][p]);
              rresidual[d][p] -= f; residual[d][p] += f;
              excess[i] -= f; excess[p] += f;
              enqueue(p);
              pushed = true;
            } else if (height[p] + 1 < min_h) min_h = height[p] + 1;
          }
        }
      }
      if (excess[i] <= 0) break;
      if (!pushed) {
        if (to_sink[i] > 0 && 1 + 1 <= min_h) min_h = std::min(min_h, 1);
        // gap heuristic: if i's old level empties, everything above it is
        // disconnected from the sink.
        int old_h = height[i];
        if (old_h < n && --count_h[old_h] == 0) {
          for (int v = 0; v < n; ++v)
            if (height[v] > old_h && height[v] < n) {
              count_h[height[v]]--;
              height[v] = n;
            }
          height[i] = n;
          return;
        }
        height[i] = (min_h >= n) ? n : min_h;
        if (height[i] >= n) return;
        count_h[height[i]]++;
      }
    }
  }

  void solve(uint8_t* out_fg) {
    global_relabel();
    long long work = 0, relabel_interval = (long long)6 * n;
    while (!active.empty()) {
      int i = active.front(); active.pop();
      in_queue[i] = 0;
      if (excess[i] > 0 && height[i] < n) discharge(i);
      if (excess[i] > 0 && height[i] < n) enqueue(i);
      if (++work % relabel_interval == 0) global_relabel();
    }
    // Min-cut: source side = cannot reach the sink in the residual graph.
    global_relabel();
    for (int i = 0; i < n; ++i) out_fg[i] = height[i] >= n ? 1 : 0;
  }
};

const int Solver::DY[4] = {0, -1, -1, -1};
const int Solver::DX[4] = {-1, 0, -1, 1};

}  // namespace

extern "C" {

void grid_mincut(int H, int W, int connectivity, const float* excess,
                 const float* caps, unsigned char* out_fg) {
  Solver s(H, W, connectivity, excess, caps);
  s.solve(out_fg);
}

}  // extern "C"
