"""Sums over the "data" mesh axis for data-parallel training.

The JAX package trains data-parallel as one jitted step over a sharded
batch: XLA inserts every psum, so the sharded step computes the single-
device step's function.  The port runs each data rank's forward and
backward on its own shard, so it makes the same function in three pieces:

* `sum_over_data` sums small tensors over the ranks, in rank order within
  a process and then over processes (``torch.distributed.all_reduce``):
  the batch-wide sums the objective and InputNorm take (data only, no
  gradient), the loss, the evaluation counts;
* `BatchDraws` hands each rank its slice of one draw over the whole batch
  from the trainer's generator, so dropout sees the single-device masks;
* `sum_gradients` sums the ranks' gradients: one flattened float32 buffer
  of (rows, 128) per rank through the ring reduce-scatter (K3) and then
  the ring all-gather (K2) over the process's data ring (their plain
  versions on the CPU), then over processes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import GraphMesh, process_count
from .ring import ring_all_gather, ring_reduce_scatter

#: Columns of the flattened gradient buffer: 512-byte float32 rows, so a
#: rank's chunk is always a multiple of the kernels' 16 bytes.
GRAD_COLS = 128


def over_processes(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes of the job, in place (no-op in one
    process)."""
    if process_count() > 1:
        import torch.distributed as dist
        dist.all_reduce(t)
    return t


def sum_over_data(ts) -> torch.Tensor:
    """The sum of one tensor per local data rank, in rank order, then over
    processes."""
    ts = list(ts)
    acc = ts[0].clone()
    for t in ts[1:]:
        acc = acc + t
    return over_processes(acc)


def flat_rows(ts, n: int) -> tuple[torch.Tensor, int]:
    """The float32 concatenation of `ts`, zero-padded to (rows, GRAD_COLS)
    with rows a multiple of `n`; and the element count before padding."""
    flat = torch.cat([t.reshape(-1).float() for t in ts])
    numel = flat.numel()
    rows = -(-numel // GRAD_COLS)
    rows = -(-rows // n) * n
    return F.pad(flat, (0, rows * GRAD_COLS - numel)).view(rows,
                                                           GRAD_COLS), numel


@torch.no_grad()
def sum_gradients(per_rank, ring: GraphMesh) -> list[torch.Tensor]:
    """Gradients summed over the data axis.  `per_rank` holds one list of
    gradient tensors per rank of `ring` (each list in one parameter
    order).  Each rank's list is flattened to one (rows, 128) float32
    buffer; `ring_reduce_scatter` (K3 on the card) leaves rank r the sum of
    row block r, summed in ring order, and `ring_all_gather` (K2) gives
    every rank the whole sum; one copy is then summed over processes and
    cut back into the parameters' shapes and dtypes."""
    per_rank = list(per_rank)
    if len(per_rank) != ring.size:
        raise ValueError(f"{len(per_rank)} gradient lists for a data ring "
                         f"of {ring.size}")
    bufs = [flat_rows(gs, ring.size)[0] for gs in per_rank]
    if ring.size > 1:
        total = ring_all_gather(ring_reduce_scatter(bufs, ring), ring)[0]
    else:
        total = bufs[0]
    flat = over_processes(total.reshape(-1))
    out, o = [], 0
    for g in per_rank[0]:
        out.append(flat[o:o + g.numel()].view(g.shape).to(g.dtype))
        o += g.numel()
    return out


class BatchDraws:
    """One generator's U[0, 1) draws over a batch of `n_shards` equal
    shards, handed out per shard.

    `rank(r)` is a draw source for the models' dropout (see
    ``models.layers.uniform``): its i-th ``rand((g, ...))`` is rows
    [r g, (r + 1) g) of the i-th ``torch.rand((n_shards g, ...))`` drawn
    from the generator, which the first shard to ask draws and the others
    reuse.  So each shard sees its slice of the single-device draws, and
    every process of a job, drawing from a generator of the same seed,
    sees the same ones."""

    def __init__(self, generator: torch.Generator, n_shards: int):
        self.generator = generator
        self.n_shards = n_shards
        self.draws: list[torch.Tensor] = []

    def rank(self, r: int) -> "_ShardDraws":
        return _ShardDraws(self, r)


class _ShardDraws:
    def __init__(self, src: BatchDraws, r: int):
        self.src, self.r, self.i = src, r, 0

    def rand(self, shape: tuple, device) -> torch.Tensor:
        src, g = self.src, shape[0]
        full_shape = (src.n_shards * g, *shape[1:])
        if self.i == len(src.draws):
            src.draws.append(torch.rand(full_shape, generator=src.generator,
                                        device=device))
        full = src.draws[self.i]
        if tuple(full.shape) != full_shape:
            raise ValueError(f"shard {self.r} draws {tuple(shape)} where "
                             f"another drew {tuple(full.shape)}")
        self.i += 1
        return full[self.r * g:(self.r + 1) * g]
