"""The least bytes GATTrimapNet's attention must move, counted from the
graph's valid nodes and edges and the configuration's widths.

Per GATv2 layer on `n` valid nodes and `e` valid directed edges of
`edge_dim` features, with `width` = heads × head size features a node:
W_l x and W_r x read once at the attention's stated precision
(`operand_bytes`: bfloat16, 2), each edge's attributes (float32) and its
source and destination (int32, enough for any graph the build makes)
read once, and the float32 output written once.  A banded form's slots,
padding and repeated reads are not counted, so the share of the roofline
reads the same work whatever implements the attention.
"""

from __future__ import annotations


def layer_bytes(n: int, e: int, width: int, edge_dim: int = 5,
                operand_bytes: int = 2) -> int:
    """One attention layer."""
    return (2 * n * width * operand_bytes + e * (4 * edge_dim + 2 * 4)
            + n * width * 4)


def forward_bytes(nodes: int, edges: int, n_layers: int, heads: int,
                  head_dim: int, edge_dim: int = 5,
                  operand_bytes: int = 2) -> int:
    """Every attention layer of the forwards over graphs that hold `nodes`
    valid nodes and `edges` valid directed edges in all."""
    return n_layers * layer_bytes(nodes, edges, heads * head_dim, edge_dim,
                                  operand_bytes)
