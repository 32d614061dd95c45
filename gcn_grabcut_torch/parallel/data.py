"""Sums over the "data" mesh axis for data-parallel training.

The JAX package trains data-parallel as one jitted step over a sharded
batch: XLA inserts every psum, so the sharded step computes the single-
device step's function.  The port runs each data rank's forward and
backward on its own shard, so it makes the same function in three pieces:

* `sum_over_data` sums small tensors over the ranks, in rank order within
  a process and then over processes (``torch.distributed.all_reduce``,
  whose gradient is the all-reduced gradient of the sum): the batch-wide
  sums the objective takes, the loss, the evaluation counts, and through
  `LockStep` InputNorm's statistics;
* `LockStep` runs the process's ranks' forwards one at a time in rank
  order, each in a thread of its own, so that they meet at every
  InputNorm and normalise with the whole batch's statistics; the step then
  takes one backward of the ranks' summed losses, in the calling thread;
* `BatchDraws` hands each rank its slice of one draw over the whole batch
  from the trainer's generator, so dropout sees the single-device masks;
* `sum_gradients` sums the ranks' gradients: one flattened float32 buffer
  of (rows, 128) per rank through the ring reduce-scatter (K3) and then
  the ring all-gather (K2) over the process's data ring (their plain
  versions on the CPU), then over processes.
"""

from __future__ import annotations

import contextlib
import threading

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


class _OverProcesses(torch.autograd.Function):
    """`over_processes` with its gradient: the gradient of the job's sum
    with respect to each process's term is the sum of every process's
    gradient of it."""

    @staticmethod
    def forward(ctx, t):
        return over_processes(t.clone())

    @staticmethod
    def backward(ctx, g):
        return over_processes(g.clone())


def sum_over_data(ts) -> torch.Tensor:
    """The sum of one tensor per local data rank, in rank order, then over
    processes; differentiable."""
    ts = list(ts)
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t
    return _OverProcesses.apply(acc) if process_count() > 1 else acc


class _Aborted(Exception):
    """Another rank's forward failed."""


class LockStep:
    """One function per local data rank, each run in a thread of its own,
    one at a time in rank order: rank r runs until it calls `total(r, t)`,
    rank r + 1 then runs to the same call, and the last rank's call sums
    the ranks' tensors (`sum_over_data`: in rank order, then over
    processes) and hands the sum to every rank, rank 0 first.  So the
    ranks' forwards meet at each synchronised norm and autograd records
    the sums that join them; the gradient is one backward in the calling
    thread (no thread waits in a backward, which on a card would block its
    autograd device thread).  The ranks run in one order on every run, so
    their operations do too.  The turn passes as a lock that rank r + 1
    waits on and rank r releases: one thread wakes at each hand-off."""

    def __init__(self, n: int):
        self.n = n
        self._turn = [threading.Lock() for _ in range(n)]
        for lock in self._turn:
            lock.acquire()
        self._parts: list[torch.Tensor] = []
        self._sum = None
        self._error = None

    def _wait_turn(self, r: int) -> None:
        self._turn[r].acquire()
        if self._error is not None:
            raise _Aborted

    def _pass(self, r: int) -> None:
        self._turn[(r + 1) % self.n].release()

    def total(self, r: int, t: torch.Tensor) -> torch.Tensor:
        """Rank r's term; returns the sum over every rank of the job."""
        self._parts.append(t)
        if r == self.n - 1:
            if len(self._parts) != self.n:
                raise RuntimeError("the ranks' forwards met at different "
                                   "norms")
            self._sum, self._parts = sum_over_data(self._parts), []
        self._pass(r)
        self._wait_turn(r)
        return self._sum

    def run(self, fn) -> list:
        """[fn(0), ..., fn(n - 1)], each in its own thread, in lock step;
        an exception in any of them is raised here."""
        out = [None] * self.n
        grad = torch.is_grad_enabled()

        def body(r):
            try:
                self._wait_turn(r)
                with torch.set_grad_enabled(grad):
                    out[r] = fn(r)
                self._pass(r)
            except _Aborted:
                pass
            except BaseException as e:          # noqa: BLE001 -- re-raised
                self._error = self._error or e
                for lock in self._turn:         # wake every waiting rank
                    with contextlib.suppress(RuntimeError):
                        lock.release()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        self._turn[0].release()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return out


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
