"""Ring all-gather and ring reduce-scatter over a `GraphMesh`.

Counterpart of ``gcn_grabcut_tpu/parallel/ring_pallas.py``.  A collective
takes one tensor per rank of the mesh and returns one tensor per rank:

* `ring_all_gather`: rank r's (chunk, D) block -> the (n chunk, D)
  concatenation of every rank's block, on every rank;
* `ring_reduce_scatter`: rank r's (n chunk, D) tensor g_r -> the (chunk, D)
  block sum_j g_j[r chunk:(r + 1) chunk].

Each is the other's gradient, as the JAX package's custom VJPs make them,
so training through the halo runs the reduce-scatter (K3) backward.

On CUDA tensors both launch the hand-written kernels of
``csrc/ring_collectives.cu`` (K2, a one-shot direct write of each rank's
block into every rank's output; K3, a one-shot direct read of every rank's
block), one cooperative launch per call, float32 or bfloat16;
there is no fallback, and a kernel that cannot build or launch raises.  On
CPU tensors they run the plain versions below.  The reduce-scatter sums in
ring order in the input dtype on both, so kernel and plain version agree
exactly.  Unlike the JAX version, which silently drops trailing rows,
`ring_reduce_scatter` raises ``ValueError`` when the rows are not a
multiple of the ring size.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from .mesh import SIGNAL_BLOCKS, GraphMesh

#: The kernels' pointer tables hold at most this many ranks.
MAX_RANKS = 16
DTYPES = (torch.float32, torch.bfloat16)


def ring_all_gather_plain(blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """The plain version of K2: the concatenation, one copy per rank."""
    return [torch.cat(blocks) for _ in blocks]


def ring_reduce_scatter_plain(gs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The plain version of K3, summing in ring order in the input dtype:
    acc = g_{b+1}[b], then acc = g_{b+k}[b] + acc for k = 2..n-1, then
    out_b = g_b[b] + acc (indices mod n)."""
    n = len(gs)
    chunk = gs[0].shape[0] // n

    def blk(j: int, b: int) -> torch.Tensor:
        return gs[j % n][b * chunk:(b + 1) * chunk]

    outs = []
    for b in range(n):
        acc = blk(b + 1, b)
        for k in range(2, n):
            acc = blk(b + k, b) + acc
        outs.append(blk(b, b) + acc)
    return outs


def _check(ts: list[torch.Tensor], mesh: GraphMesh, name: str) -> None:
    if len(ts) != mesh.size:
        raise ValueError(f"{name}: {len(ts)} tensors for a mesh of "
                         f"{mesh.size} ranks")
    t0 = ts[0]
    for t in ts:
        if t.device != mesh.device:
            raise ValueError(f"{name}: a tensor on {t.device}, the mesh on "
                             f"{mesh.device}")
        if t.dim() != 2 or t.shape != t0.shape or t.dtype != t0.dtype:
            raise ValueError(f"{name}: every rank needs one 2-D tensor of one "
                             f"shape and dtype, got {tuple(t.shape)} "
                             f"{t.dtype} and {tuple(t0.shape)} {t0.dtype}")


def _check_rows(gs: list[torch.Tensor], n: int) -> None:
    if gs[0].shape[0] % n:
        raise ValueError(f"ring_reduce_scatter: {gs[0].shape[0]} rows do not "
                         f"split into {n} equal blocks")


def _check_cuda(ts: list[torch.Tensor], mesh: GraphMesh, chunk_bytes: int,
                name: str) -> None:
    if mesh.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors")
    if ts[0].dtype not in DTYPES:
        raise TypeError(f"{name}: takes float32 or bfloat16, got "
                        f"{ts[0].dtype}")
    if not 2 <= mesh.size <= MAX_RANKS:
        raise ValueError(f"{name}: the kernel takes 2..{MAX_RANKS} ranks, "
                         f"got {mesh.size}")
    if chunk_bytes % 16 or chunk_bytes == 0:
        raise ValueError(f"{name}: chunk * D * elt = {chunk_bytes} bytes is "
                         f"not a positive multiple of 16")
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs contiguous 16-byte aligned "
                             f"tensors")


def _table(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _delays(delay_ns, n: int):
    if delay_ns is None:
        return None
    d = torch.as_tensor(delay_ns, dtype=torch.int32).reshape(n, n)
    return (ctypes.c_int * (n * n))(*d.flatten().tolist())


def _bind(fn):
    """Set the ctypes signature shared by the library's entry points."""
    fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)] * 3
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(name: str):
    from ..kernels import load
    return _bind(getattr(load("ring_collectives"), name))


def _launch(name: str, tables: list, mesh: GraphMesh, chunk_bytes: int,
            delay_ns) -> None:
    fn = _kernel(name)
    n = mesh.size
    with torch.cuda.device(mesh.device):
        stream = torch.cuda.current_stream(mesh.device).cuda_stream
        err = fn(*(_table(t) for t in tables), n, chunk_bytes,
                 SIGNAL_BLOCKS, mesh.next_epoch(), _delays(delay_ns, n),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ring_all_gather_cuda(blocks: list[torch.Tensor], mesh: GraphMesh,
                         delay_ns=None) -> list[torch.Tensor]:
    """Launch K2 on the current stream.  It allocates the outputs and
    nothing else.  `delay_ns`, an optional (n, n) table of nanoseconds, is
    read as (rank, phase): rank r stalls delay_ns[r][0] before it enters
    and delay_ns[r][1] after its copies, before it signals them done."""
    _check(blocks, mesh, "ring_all_gather")
    chunk, d = blocks[0].shape
    chunk_bytes = chunk * d * blocks[0].element_size()
    _check_cuda(blocks, mesh, chunk_bytes, "ring_all_gather")
    outs = [torch.empty((mesh.size * chunk, d), dtype=blocks[0].dtype,
                        device=mesh.device) for _ in blocks]
    _launch("ring_all_gather", [blocks, outs, list(mesh.signals)], mesh,
            chunk_bytes, delay_ns)
    ring_all_gather.kernel_launches += 1
    return outs


def ring_reduce_scatter_cuda(gs: list[torch.Tensor], mesh: GraphMesh,
                             delay_ns=None) -> list[torch.Tensor]:
    """Launch K3 on the current stream.  It allocates the outputs and
    nothing else.  `delay_ns`, an optional (n, n) table of nanoseconds, is
    read as (rank, phase): rank r stalls delay_ns[r][0] before it enters
    and delay_ns[r][1] after its reads, before it signals them done."""
    _check(gs, mesh, "ring_reduce_scatter")
    n = mesh.size
    _check_rows(gs, n)
    rows, d = gs[0].shape
    chunk = rows // n
    chunk_bytes = chunk * d * gs[0].element_size()
    _check_cuda(gs, mesh, chunk_bytes, "ring_reduce_scatter")
    outs = [torch.empty((chunk, d), dtype=gs[0].dtype, device=mesh.device)
            for _ in gs]
    name = ("reduce_scatter_bf16" if gs[0].dtype == torch.bfloat16
            else "reduce_scatter_f32")
    _launch(name, [gs, outs, list(mesh.signals)], mesh, chunk_bytes,
            delay_ns)
    ring_reduce_scatter.kernel_launches += 1
    return outs


def _all_gather(blocks, mesh: GraphMesh | None) -> list[torch.Tensor]:
    if mesh is not None and blocks[0].device.type == "cuda":
        return ring_all_gather_cuda([b.contiguous() for b in blocks], mesh)
    return ring_all_gather_plain(list(blocks))


def _reduce_scatter(gs, mesh: GraphMesh | None) -> list[torch.Tensor]:
    if mesh is not None and gs[0].device.type == "cuda":
        return ring_reduce_scatter_cuda([g.contiguous() for g in gs], mesh)
    return ring_reduce_scatter_plain(list(gs))


def _fill(grads, like: torch.Size, ref: torch.Tensor) -> list[torch.Tensor]:
    """Zeros for the outputs no loss reached."""
    return [torch.zeros(like, dtype=ref.dtype, device=ref.device)
            if g is None else g for g in grads]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *blocks):
        ctx.mesh = mesh
        out = _all_gather(blocks, mesh)
        ctx.out_shape = out[0].shape
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        return (None, *_reduce_scatter(_fill(grads, ctx.out_shape, ref),
                                       ctx.mesh))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *gs):
        ctx.mesh = mesh
        out = _reduce_scatter(gs, mesh)
        ctx.out_shape = out[0].shape
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        ref = next(g for g in grads if g is not None)
        return (None, *_all_gather(_fill(grads, ctx.out_shape, ref),
                                   ctx.mesh))


def ring_all_gather(blocks, mesh: GraphMesh) -> list[torch.Tensor]:
    """One (chunk, D) block per rank -> one (n chunk, D) tensor per rank,
    the blocks in rank order.  Differentiable: the gradient is
    `ring_reduce_scatter`.  A one-rank mesh returns its block."""
    blocks = list(blocks)
    _check(blocks, mesh, "ring_all_gather")
    if mesh.size == 1:
        return blocks
    return list(_AllGather.apply(mesh, *blocks))


def plain_all_gather(blocks) -> list[torch.Tensor]:
    """`ring_all_gather`'s function through the plain versions on every
    device: the concatenation forward, `ring_reduce_scatter_plain`
    backward, so its gradient adds the ranks' copies in K3's order and
    equals the ring's bit for bit.  Launches no kernel."""
    blocks = list(blocks)
    if len(blocks) == 1:
        return blocks
    return list(_AllGather.apply(None, *blocks))


def ring_reduce_scatter(gs, mesh: GraphMesh) -> list[torch.Tensor]:
    """One (n chunk, D) tensor per rank -> rank r's (chunk, D) block of
    their sum.  Raises ValueError when the rows are not a multiple of n.
    Differentiable: the gradient is `ring_all_gather`."""
    gs = list(gs)
    _check(gs, mesh, "ring_reduce_scatter")
    _check_rows(gs, mesh.size)
    if mesh.size == 1:
        return gs
    return list(_ReduceScatter.apply(mesh, *gs))


#: Launches of K2 and K3 since each count was last set to 0.
ring_all_gather.kernel_launches = 0
ring_reduce_scatter.kernel_launches = 0
