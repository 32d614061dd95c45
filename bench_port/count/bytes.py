"""The least bytes a call must move, counted from its tensors' shapes.

Each input tensor is read once and each output tensor written once,
whatever the kernel reads again.  For the min-cut
(`ops.maxflow.grid_mincut_batch`) that is the excess plane and the
forward and backward residual planes in, and the source-side mask, the
excess and the residual planes out.
"""

from __future__ import annotations

import math


def tensor_bytes(shape, itemsize: int) -> int:
    return math.prod(shape) * itemsize


def call_bytes(inputs, outputs) -> int:
    """`inputs` and `outputs`: (shape, itemsize) pairs."""
    return (sum(tensor_bytes(s, i) for s, i in inputs)
            + sum(tensor_bytes(s, i) for s, i in outputs))
