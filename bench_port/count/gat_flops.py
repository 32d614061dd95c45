"""Model FLOPs of a GATTrimapNet forward, counted from graph sizes on the
edge-list form.

On a graph of `n` valid nodes and `e` valid directed edges, with `d`
hidden features, `w` = heads × head size attention features, `in_dim`
node and `edge_dim` edge features and `classes` outputs:

    2 n in_dim d + 2 n d w        the input projection and the skip
    per layer (GATv2, edge gate):
      2 · 2 n d_in w              W_l x and W_r x (d_in = d, then w)
      2 e edge_dim w              W_e a over the edges
      6 (e + n) w                 per edge and self loop: the two adds of
                                  z, the score's multiply-add with att,
                                  the message's multiply-add
      2 e edge_dim w + 2 e w w    the gate's two Linears over the edges
      e w + n w                   the gate's mean and its product
    2 n w + 2 n w + n w           GlobalContext: the pooling score, the
                                  pooled sum and the node gating
    2 n w d + 2 n d classes       the head

whatever slots a banded form computes.  Elementwise work (InputNorm,
LayerNorm, GELU, LeakyReLU, sigmoid, the softmax's exponentials and
sums) and GlobalContext's per-graph matmuls are left out, so the count
is a lower bound of what a forward computes.
"""

from __future__ import annotations


def gatv2_flops(n: int, e: int, d_in: int, width: int,
                edge_dim: int = 5) -> int:
    """One GATv2 layer."""
    return (4 * n * d_in * width + 2 * e * edge_dim * width
            + 6 * (e + n) * width)


def gate_flops(n: int, e: int, width: int, edge_dim: int = 5) -> int:
    """One layer's edge gate (``EdgeInjection``)."""
    return (2 * e * edge_dim * width + 2 * e * width * width
            + e * width + n * width)


def forward_flops(nodes: int, edges: int, hidden: int, n_layers: int,
                  heads: int, head_dim: int, edge_dim: int = 5,
                  in_dim: int = 19, classes: int = 3) -> int:
    """One forward over graphs that hold `nodes` valid nodes and `edges`
    valid directed edges in all (the count is linear in the sizes, so a
    window's totals give the window's count)."""
    n, e, d, w = nodes, edges, hidden, heads * head_dim
    layers = sum(gatv2_flops(n, e, d if i == 0 else w, w, edge_dim)
                 + gate_flops(n, e, w, edge_dim) for i in range(n_layers))
    return (2 * n * in_dim * d + 2 * n * d * w + layers + 5 * n * w
            + 2 * n * w * d + 2 * n * d * classes)
