"""Edge-partitioned neighbourhood aggregation for large graphs.

Counterpart of ``gcn_grabcut_tpu/parallel/partition.py``.  The node axis is
block-partitioned over the ranks of a `GraphMesh` and edges are partitioned
by their destination block, so each rank aggregates only into the nodes it
owns:

  1. rank i holds a contiguous node block x_i (N/n, D);
  2. the source features of its edges come from the full node axis,
     assembled on every rank by the halo exchange (`ring_all_gather`, K2,
     with ``halo="pallas_ring"``; plain PyTorch copies with ``halo="xla"``;
     the JAX package's names are kept so the two packages' calls read
     alike);
  3. rank i sums its edge shard's messages into its own block, in edge
     order (``ops.region.Segments``, sorted once per edge partition): no
     float atomics, which add in no fixed order on the card, so two runs
     give the same bits.

The callables take and return whole tensors, as the JAX package's
``shard_map``-ed functions do; the blocks are views of them.  They are
differentiable: the halo's gradient is the ring reduce-scatter (K3).
Each takes a `GraphMesh`, or the "graph" axis of a 2-D ("data", "graph")
`Mesh`, where the data axis replicates the aggregation (its first row
runs it); as in the JAX package, the ring halo takes a graph-only mesh.

The host-side edge partitioners are the JAX package's, copied (numpy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.region import Segments
from .mesh import GraphMesh, Mesh
from .ring import plain_all_gather, ring_all_gather

HALOS = ("xla", "pallas_ring")


def partition_edges_by_dst(edge_src: np.ndarray, edge_dst: np.ndarray,
                           edge_mask: np.ndarray, n_nodes: int,
                           n_shards: int):
    """Reorder + pad edges so shard i holds exactly the edges whose dst lies
    in node block i.  Returns (src, dst, mask) with length
    n_shards * per_shard, per_shard = max over shards (rounded up)."""
    block = (n_nodes + n_shards - 1) // n_shards
    owner = np.minimum(edge_dst // block, n_shards - 1)
    owner = np.where(edge_mask > 0, owner, -1)

    shards = [np.nonzero(owner == i)[0] for i in range(n_shards)]
    per_shard = max(1, max(len(s) for s in shards))

    src = np.zeros(n_shards * per_shard, edge_src.dtype)
    dst = np.zeros(n_shards * per_shard, edge_dst.dtype)
    msk = np.zeros(n_shards * per_shard, np.float32)
    for i, idx in enumerate(shards):
        o = i * per_shard
        src[o:o + len(idx)] = edge_src[idx]
        dst[o:o + len(idx)] = edge_dst[idx]
        # The mask column carries the edge weight (1.0 for plain masks).
        msk[o:o + len(idx)] = edge_mask[idx]
        # Padded slots point at the block's first node with zero mask.
        dst[o + len(idx):o + per_shard] = min(i * block, n_nodes - 1)
    return src, dst, msk


def partition_edges_2d(edge_src: np.ndarray, edge_dst: np.ndarray,
                       edge_mask: np.ndarray, n_nodes: int, n_shards: int):
    """Bucket edges by (dst block, src block) for the ring schedule.

    Returns (src, dst, mask) shaped (n_shards, n_shards, per_bucket):
    bucket [i, j] holds the edges whose destination lies in node block i and
    source in node block j, with indices made block-relative."""
    block = (n_nodes + n_shards - 1) // n_shards
    di = np.minimum(edge_dst // block, n_shards - 1)
    sj = np.minimum(edge_src // block, n_shards - 1)
    valid = edge_mask > 0

    counts = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(counts, (di[valid], sj[valid]), 1)
    per_bucket = max(1, int(counts.max()))

    src = np.zeros((n_shards, n_shards, per_bucket), np.int32)
    dst = np.zeros((n_shards, n_shards, per_bucket), np.int32)
    msk = np.zeros((n_shards, n_shards, per_bucket), np.float32)
    fill = np.zeros((n_shards, n_shards), np.int64)
    for e in np.nonzero(valid)[0]:
        i, j = di[e], sj[e]
        k = fill[i, j]
        src[i, j, k] = edge_src[e] - j * block
        dst[i, j, k] = edge_dst[e] - i * block
        # The mask column carries the edge weight (1.0 for plain masks).
        msk[i, j, k] = edge_mask[e]
        fill[i, j] = k + 1
    return src, dst, msk


def _graph_axis(mesh, halo: str | None = None) -> GraphMesh:
    """The ring of a mesh's "graph" axis."""
    if not isinstance(mesh, Mesh):
        return mesh
    if halo == "pallas_ring":
        raise ValueError(
            "halo='pallas_ring' requires a single-axis ('graph',) mesh; "
            f"got axes {mesh.axis_names}.  Build the aggregation over the "
            "graph axis of one data row (mesh.graph_mesh(i))")
    return mesh.graph_mesh(0)


def _blocks(x: torch.Tensor, mesh: GraphMesh, n_nodes: int):
    if x.shape[0] != n_nodes or n_nodes % mesh.size:
        raise ValueError(f"x has {x.shape[0]} rows; expected {n_nodes}, a "
                         f"multiple of the {mesh.size} ranks")
    return list(x.split(n_nodes // mesh.size))


def shard_segments(mesh: GraphMesh | Mesh, n_nodes: int, dst: torch.Tensor
                   ) -> list[Segments]:
    """Each rank's destinations of `partition_edges_by_dst`'s shards,
    block-relative (clamped into the block, as `sharded_scatter_add`
    clamps them), sorted once for its fixed-order sums."""
    mesh = _graph_axis(mesh)
    block = n_nodes // mesh.size
    return [Segments((d.long() - i * block).clamp(0, block - 1), block)
            for i, d in enumerate(dst.chunk(mesh.size))]


def sharded_scatter_add(mesh: GraphMesh, n_nodes: int, halo: str = "xla"):
    """An edge-partitioned aggregation (x, src, dst, mask) -> out.

    x is (n_nodes, D), rank i owning rows [i N/n, (i + 1) N/n); src, dst and
    mask are `partition_edges_by_dst`'s arrays, rank i owning the i-th of n
    equal shards.  Each rank assembles the full node axis, weighs its
    edges' messages and sums them into its own block in float32, in edge
    order (``ops.region`` segment sums; masked and out-of-block messages
    add zeros).  ``halo="pallas_ring"`` assembles with the ring all-gather
    kernel (K2), ``halo="xla"`` with the plain copies; both take K3's order
    for the gradient's sum over ranks, so the two give the same bits.
    `segments`, `shard_segments(mesh, n_nodes, dst)`, keeps the sort of a
    fixed edge partition from one call to the next."""
    if halo not in HALOS:
        raise ValueError(f"unknown halo backend: {halo!r}")
    mesh = _graph_axis(mesh, halo)

    def agg(x, src, dst, mask, segments=None):
        xs = _blocks(x, mesh, n_nodes)
        if halo == "pallas_ring":
            fulls = ring_all_gather(xs, mesh)
        else:
            fulls = plain_all_gather(xs)
        if segments is None:
            segments = shard_segments(mesh, n_nodes, dst)
        block = xs[0].shape[0]
        outs = []
        for i, (x_full, s, d, m, segs) in enumerate(zip(
                fulls, src.chunk(mesh.size), dst.chunk(mesh.size),
                mask.chunk(mesh.size), segments)):
            base = i * block
            in_block = ((d >= base) & (d < base + block)).float()
            msgs = x_full[s].float() * m[:, None] * in_block[:, None]
            outs.append(segs.sum(msgs).to(x.dtype))
        return torch.cat(outs)

    return agg


def ring_segments(mesh: GraphMesh | Mesh, n_nodes: int, dst2d: torch.Tensor
                  ) -> list[Segments]:
    """Each rank's destinations of `partition_edges_2d`'s buckets in ring
    order (bucket [i, (i - s) mod n] for s = 0 .. n-1), clamped into the
    block and sorted once for `ring_scatter_add`'s sums."""
    mesh = _graph_axis(mesh)
    n, block = mesh.size, n_nodes // mesh.size
    return [Segments(torch.cat([dst2d[i, (i - s) % n] for s in range(n)])
                     .long().clamp(0, block - 1), block) for i in range(n)]


def ring_scatter_add(mesh: GraphMesh, n_nodes: int):
    """Ring-scheduled edge-partitioned aggregation (x, src2d, dst2d,
    mask2d) -> out, with `partition_edges_2d`'s buckets.

    At step s rank i holds the block of rank j = (i - s) mod n, as the JAX
    package's `lax.ppermute` rotation leaves it, and aggregates bucket
    [i, j]; its sum adds the steps' messages in that order, in float32.
    The JAX package runs no Pallas kernel here, so the rotation is plain
    block indexing.  `segments` is `ring_segments(mesh, n_nodes, dst2d)`,
    kept from one call to the next."""
    mesh = _graph_axis(mesh)

    def agg(x, src2d, dst2d, mask2d, segments=None):
        xs = _blocks(x, mesh, n_nodes)
        n, block = mesh.size, xs[0].shape[0]
        if segments is None:
            segments = ring_segments(mesh, n_nodes, dst2d)
        outs = []
        for i in range(n):
            msgs = torch.cat([
                xs[j][src2d[i, j].long().clamp(0, block - 1)].float()
                * mask2d[i, j][:, None]
                for j in ((i - s) % n for s in range(n))])
            outs.append(segments[i].sum(msgs).to(x.dtype))
        return torch.cat(outs)

    return agg


def mesh_aggregators(mesh: GraphMesh | Mesh, edge_src, edge_dst, edge_mask,
                     n_nodes: int, method: str = "ring", halo: str = "xla"):
    """(gcn_propagate, mean_propagate) callables for
    ``ResGCNNet.forward(g, aggregators)`` that run the neighbourhood
    aggregation edge-partitioned over the mesh, on (1, N, D) activations.

    GCN weights fold the symmetric normalisation and self loops into
    per-edge weights as ``models/large.py`` does; the mean aggregator uses
    1/deg(dst).  ``method="ring"`` rotates node blocks (`ring_scatter_add`;
    `halo` is not used); ``method="allgather"`` assembles the full node
    axis per layer (`sharded_scatter_add` with `halo`).  The edge arrays
    are host arrays; their partitions land on the mesh's device."""
    mesh = _graph_axis(mesh, halo if method == "allgather" else None)
    n_sh = mesh.size
    block = -(-n_nodes // n_sh)
    n_pad = block * n_sh

    keep = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[keep].astype(np.int64)
    dst = np.asarray(edge_dst)[keep].astype(np.int64)
    deg = np.bincount(dst, minlength=n_pad).astype(np.float64)
    dhat = deg + 1.0
    dis = 1.0 / np.sqrt(dhat)
    loops = np.arange(n_nodes)
    g_src = np.concatenate([src, loops])
    g_dst = np.concatenate([dst, loops])
    g_w = np.concatenate([dis[src] * dis[dst],
                          1.0 / dhat[:n_nodes]]).astype(np.float32)
    m_w = (1.0 / np.maximum(deg, 1.0))[dst].astype(np.float32)

    if method == "ring":
        agg, partition = ring_scatter_add(mesh, n_pad), partition_edges_2d
        segments = ring_segments
    elif method == "allgather":
        agg = sharded_scatter_add(mesh, n_pad, halo=halo)
        partition, segments = partition_edges_by_dst, shard_segments
    else:
        raise ValueError(f"unknown method: {method!r}")

    def build(ss, dd, ww):
        ps, pd, pw = (torch.as_tensor(a, device=mesh.device)
                      for a in partition(ss, dd, ww, n_pad, n_sh))
        ps, pd = ps.long(), pd.long()
        segs = segments(mesh, n_pad, pd)

        def prop(h):
            n = h.shape[1]
            hp = F.pad(h[0], (0, 0, 0, n_pad - n))
            return agg(hp, ps, pd, pw, segs)[:n][None]
        return prop

    return build(g_src, g_dst, g_w), build(src, dst, m_w)


def sharded_gcn_layer(mesh: GraphMesh, n_nodes: int):
    """Edge-partitioned GCN propagation: h' = D^-1/2 (A+I) D^-1/2 h W, with
    the weight multiply local to each node block and only the halo
    crossing ranks."""
    agg = sharded_scatter_add(mesh, n_nodes)

    def gcn(x, w, src, dst, mask, deg_inv_sqrt):
        xw = torch.einsum("nd,df->nf", x, w)
        h = xw * deg_inv_sqrt[:, None]
        h = agg(h, src, dst, mask)
        h = h * deg_inv_sqrt[:, None]
        h = h + xw * (deg_inv_sqrt ** 2)[:, None]
        return h

    return gcn
