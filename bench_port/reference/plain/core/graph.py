"""Padded, fixed-shape graph containers and shared constants.

Counterpart of ``gcn_grabcut_tpu/core/graph.py`` (constants, ``GraphBatch``,
``make_graph_batch``, ``single_graph``, ``Label``); `NEG_INF` and
`masked_softmax` are ``core/scatter.py``'s, imported here for the code
that takes them from this module.  Every graph is padded to a static (N, E)
budget and batches are dense (G, N, F) stacks; padded edges have src ==
dst == 0 and edge_mask == 0.

Conventions: trimap labels match OpenCV (BG=0, FG=1, PR_BG=2, PR_FG=3);
node classes BG=0, UNK=1, FG=2; 16 image + 3 prior node features; 5 edge
features.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from .scatter import NEG_INF, masked_softmax  # noqa: F401 -- re-exported

N_IMAGE_FEATS = 16
N_PRIOR_FEATS = 3
N_NODE_FEATS = N_IMAGE_FEATS + N_PRIOR_FEATS  # 19
N_EDGE_FEATS = 5

TRIMAP_BG = 0       # cv2.GC_BGD
TRIMAP_FG = 1       # cv2.GC_FGD
TRIMAP_PROB_BG = 2  # cv2.GC_PR_BGD
TRIMAP_PROB_FG = 3  # cv2.GC_PR_FGD


class Label(enum.IntEnum):
    """Pixel label constants, OpenCV's GrabCut convention (the JAX
    package's and the reference facade's names and values)."""
    BG_DEFINITE = TRIMAP_BG
    FG_DEFINITE = TRIMAP_FG
    BG_PROBABLE = TRIMAP_PROB_BG
    FG_PROBABLE = TRIMAP_PROB_FG


CLASS_BG = 0
CLASS_UNK = 1
CLASS_FG = 2

@dataclasses.dataclass
class GraphBatch:
    """A dense-padded batch of G graphs with static (N, E) budgets.

    x (G, N, F) float32, edge_src / edge_dst (G, E) int64, edge_attr
    (G, E, Fe) float32, node_mask / edge_mask / node_area (G, N | E)
    float32.  The training targets, fg_ratio (G, N) float32 and y (G, N)
    int64, are None on a graph built for inference.
    """
    x: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_attr: torch.Tensor
    node_mask: torch.Tensor
    edge_mask: torch.Tensor
    node_area: torch.Tensor
    fg_ratio: Optional[torch.Tensor] = None
    y: Optional[torch.Tensor] = None

    @property
    def n_graphs(self) -> int:
        return self.x.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.x.shape[1]


    @property
    def device(self) -> torch.device:
        return self.x.device


def make_graph_batch(x, edge_src, edge_dst, edge_attr, node_mask, edge_mask,
                     node_area=None, device=None, fg_ratio=None, y=None
                     ) -> GraphBatch:
    """Build a GraphBatch from arrays or tensors; `node_area` defaults to
    1 / (valid node count).  `device=None` keeps tensors where they are
    (numpy inputs land on the CPU)."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    def i64(a):
        return torch.as_tensor(a, device=device).long()

    node_mask = f32(node_mask)
    if node_area is None:
        counts = node_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        node_area = node_mask / counts
    return GraphBatch(
        x=f32(x), edge_src=i64(edge_src), edge_dst=i64(edge_dst),
        edge_attr=f32(edge_attr), node_mask=node_mask,
        edge_mask=f32(edge_mask), node_area=f32(node_area),
        fg_ratio=None if fg_ratio is None else f32(fg_ratio),
        y=None if y is None else i64(y))


