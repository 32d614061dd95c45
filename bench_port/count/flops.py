"""Model FLOPs of the graph convolutions, counted from graph sizes.

A graph-convolution layer of `d_in` -> `d_out` features on a graph of `n`
valid nodes and `e` valid directed edges counts 2 n d_in d_out for its
linear part and 2 (e + n) d_out for its aggregation (each edge and each
self loop one multiply-add per output feature).  ResGCNNet has `n_layers`
GCN layers and one SAGE layer, all `hidden` wide; the SAGE layer's second
linear (its root weight) is counted too.  The input projection, the prior
booster, the edge gate, the global context and the head are left out, so
the count is a lower bound of what a forward computes.
"""

from __future__ import annotations


def conv_flops(n: int, e: int, d_in: int, d_out: int) -> int:
    """One graph-convolution layer: linear part plus aggregation."""
    return 2 * n * d_in * d_out + 2 * (e + n) * d_out


def resgcn_flops(n: int, e: int, hidden: int, n_layers: int) -> int:
    """One ResGCNNet forward on one graph: `n_layers` GCN layers and the
    SAGE layer (its neighbour and root linears)."""
    return (n_layers * conv_flops(n, e, hidden, hidden)
            + conv_flops(n, e, hidden, hidden) + 2 * n * hidden * hidden)


def forward_flops(nodes: int, edges: int, members: int, hidden: int,
                  n_layers: int) -> int:
    """The graph convolutions of one forward call over graphs that hold
    `nodes` valid nodes and `edges` valid directed edges in all, for each
    of `members` ensemble members.  The count is linear in the sizes, so
    a batch's totals give the batch's count."""
    return members * resgcn_flops(nodes, edges, hidden, n_layers)
