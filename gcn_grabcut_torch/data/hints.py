"""Legacy interactive-baseline utilities: click simulation and per-region
hint encoding.  Counterpart of ``gcn_grabcut_tpu/data/hints.py`` (numpy,
with cv2's erosion), the same draws from the same RandomState.

The automatic pipeline never calls these (it uses the training-free prior),
but they are kept for ablations against the interactive baseline, as in
the original GCN-GrabCut (graph_builder.py:457-494, dataset.py:55-100).
"""

from __future__ import annotations

import numpy as np


def sample_clicks(gt_mask: np.ndarray, n_fg: int = 5, n_bg: int = 5,
                  erosion_radius: int = 8, jitter: float = 0.0,
                  rng: np.random.RandomState | None = None):
    """Randomly sample FG and BG click coordinates from a GT mask.

    The mask is eroded first so clicks avoid boundaries; `jitter` perturbs
    each click by a fraction of the image diagonal.
    Returns (fg_points, bg_points) as lists of (row, col).
    """
    import cv2
    rng = rng or np.random.RandomState()
    kernel = np.ones((erosion_radius * 2 + 1,) * 2, np.uint8)
    fg_region = cv2.erode(gt_mask.astype(np.uint8), kernel)
    bg_region = cv2.erode((1 - gt_mask).astype(np.uint8), kernel)

    H, W = gt_mask.shape
    diag = float(np.hypot(H, W))

    def _sample(region, n):
        coords = np.argwhere(region > 0)
        if len(coords) == 0:
            return []
        idx = rng.choice(len(coords), min(n, len(coords)), replace=False)
        pts = []
        for r, c in coords[idx]:
            if jitter > 0:
                r = int(np.clip(r + rng.randn() * jitter * diag, 0, H - 1))
                c = int(np.clip(c + rng.randn() * jitter * diag, 0, W - 1))
            pts.append((int(r), int(c)))
        return pts

    return _sample(fg_region, n_fg), _sample(bg_region, n_bg)


def encode_user_hints(segments: np.ndarray,
                      fg_points: list[tuple[int, int]],
                      bg_points: list[tuple[int, int]],
                      n_nodes: int | None = None) -> np.ndarray:
    """Clicks → (N, 3) hint features [has FG click, has BG click, unknown].

    Can be passed in place of the automatic prior to reproduce the old
    interactive behaviour (override the last 3 node-feature columns).
    """
    n = n_nodes or int(segments.max()) + 1
    hints = np.zeros((n, 3), np.float32)
    hints[:, 2] = 1.0
    H, W = segments.shape
    for col, pts in ((0, fg_points), (1, bg_points)):
        for r, c in pts:
            r, c = int(r), int(c)
            if 0 <= r < H and 0 <= c < W:
                nid = int(segments[r, c])
                hints[nid, col] = 1.0
                hints[nid, 2] = 0.0
    return hints
