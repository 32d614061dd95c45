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
import torch.nn.functional as F

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
    def max_edges(self) -> int:
        return self.edge_src.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def map(self, fn) -> "GraphBatch":
        """A GraphBatch of fn(field) over every field that is set."""
        return GraphBatch(**{
            f.name: None if getattr(self, f.name) is None
            else fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def graph(self, b: int) -> "GraphBatch":
        """Graph `b` as a G=1 batch (views, no copies)."""
        return self.map(lambda a: a[b:b + 1])

    def to(self, device) -> "GraphBatch":
        return self.map(lambda a: a.to(device))


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


def single_graph(x, edge_src, edge_dst, edge_attr,
                 n_nodes: Optional[int] = None,
                 max_nodes: Optional[int] = None,
                 max_edges: Optional[int] = None,
                 node_area=None, fg_ratio=None, y=None,
                 device=None) -> GraphBatch:
    """Wrap one (possibly unpadded) graph into a G=1 GraphBatch (JAX
    ``core/graph.py:160``).

    `x` is (n, F), the edges (e,) index vectors, as arrays or tensors.  A
    `max_nodes` / `max_edges` above the actual sizes pads the graph with
    masked entries.  `device=None` keeps tensors where they are (numpy
    inputs land on the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    dev = x.device
    edge_src = torch.as_tensor(edge_src, device=dev).long()
    edge_dst = torch.as_tensor(edge_dst, device=dev).long()
    edge_attr = torch.as_tensor(edge_attr, dtype=torch.float32, device=dev)
    n = x.shape[0] if n_nodes is None else n_nodes
    e = edge_src.shape[0]
    N = max_nodes or n
    E = max_edges or max(e, 1)
    if n > N or e > E:
        raise ValueError(f"{n} nodes / {e} edges exceed the budgets "
                         f"({N}, {E})")

    def pad_rows(a, rows, dtype=None):
        """(1, rows, ...): `a` with zero rows appended; None stays None."""
        if a is None:
            return None
        a = torch.as_tensor(a, dtype=dtype, device=dev)
        if a.shape[0] >= rows:
            return a[None]
        return torch.cat([a, a.new_zeros((rows - a.shape[0],)
                                         + a.shape[1:])])[None]

    node_mask = torch.zeros(N, device=dev)
    node_mask[:n] = 1.0
    edge_mask = torch.zeros(E, device=dev)
    edge_mask[:e] = 1.0
    return make_graph_batch(
        x=pad_rows(x, N), edge_src=pad_rows(edge_src, E),
        edge_dst=pad_rows(edge_dst, E), edge_attr=pad_rows(edge_attr, E),
        node_mask=node_mask[None], edge_mask=edge_mask[None],
        node_area=pad_rows(node_area, N, torch.float32),
        fg_ratio=pad_rows(fg_ratio, N, torch.float32),
        y=pad_rows(y, N, torch.int64))


def stack_graphs(graphs: list) -> GraphBatch:
    """Stack batches with identical static budgets into one batch (JAX
    ``core/graph.py:212``).  A training target set on some graphs and not
    on others is an error."""
    if not graphs:
        raise ValueError("empty graph list")
    out = {}
    for f in dataclasses.fields(GraphBatch):
        parts = [getattr(g, f.name) for g in graphs]
        if all(p is None for p in parts):
            out[f.name] = None
        elif any(p is None for p in parts):
            raise ValueError(f"{f.name} is set on some graphs only")
        else:
            out[f.name] = torch.cat(parts, dim=0)
    return GraphBatch(**out)


def pad_graph(g: GraphBatch, max_nodes: int, max_edges: int) -> GraphBatch:
    """Grow a batch's static (N, E) budgets; the new slots are masked
    zeros (JAX ``core/graph.py:218``)."""
    dn, de = max_nodes - g.max_nodes, max_edges - g.max_edges
    if dn < 0 or de < 0:
        raise ValueError(f"cannot shrink ({g.max_nodes}, {g.max_edges}) to "
                         f"({max_nodes}, {max_edges})")
    if dn == 0 and de == 0:
        return g

    def pad(a, count):
        if a is None or count == 0:
            return a
        widths = [0, 0] * (a.dim() - 2) + [0, count]
        return F.pad(a, widths)

    return GraphBatch(
        x=pad(g.x, dn), edge_src=pad(g.edge_src, de),
        edge_dst=pad(g.edge_dst, de), edge_attr=pad(g.edge_attr, de),
        node_mask=pad(g.node_mask, dn), edge_mask=pad(g.edge_mask, de),
        node_area=pad(g.node_area, dn), fg_ratio=pad(g.fg_ratio, dn),
        y=pad(g.y, dn))
