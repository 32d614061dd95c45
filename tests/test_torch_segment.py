"""The port's fixed-order sums by index on the CPU: ``ops.region``'s
`Segments`, `segment_sum` and `segment_max`, and the sharded aggregation
that sums through them (parallel/partition.py).

On the CPU every call runs the kernel's plain version; the kernel itself
(csrc/segment_sum.cu) is held against it on the card by
tests/test_torch_cuda.py and chip_smoke.py.  References: the sort +
``bincount`` + ``segment_reduce`` route the port took before the offsets
came from ``searchsorted``, ``index_add_``, the JAX package's
``jax.ops.segment_sum``, and the partition module as it was before it
dropped ``index_add_`` (copied below).  One shape: P rows into N segments.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import gcn_grabcut_torch as gt
from gcn_grabcut_torch.ops import region
from gcn_grabcut_torch.ops.region import (Segments, segment_max,
                                          segment_reduce_plain, segment_sum)
from gcn_grabcut_torch.ops.spmm import banded_spmm, spmm_plan
from gcn_grabcut_torch.parallel import partition
from gcn_grabcut_torch.parallel.mesh import make_graph_mesh
from gcn_grabcut_torch.parallel.ring import plain_all_gather, ring_all_gather

torch.set_num_threads(1)

P, N = 300, 40


def index(seed: int, sort: bool) -> torch.Tensor:
    """P indices into N segments with segments 0-2 (leading), every 7th
    and 35-39 (trailing) empty."""
    r = np.random.RandomState(seed)
    idx = r.randint(3, 35, 2 * P)
    idx = idx[idx % 7 != 4][:P]
    assert len(idx) == P
    return torch.from_numpy(np.sort(idx) if sort else idx)


def values(seed: int, cols, dtype=torch.float32) -> torch.Tensor:
    shape = (P,) if cols is None else (P, cols)
    r = np.random.RandomState(100 + seed)
    return torch.from_numpy((r.randn(*shape) * 3).astype(np.float32)
                            ).to(dtype)


def sort_bincount(idx, vals, n, op, is_sorted):
    """The route before offsets came from searchsorted."""
    if not is_sorted:
        vals = vals[torch.sort(idx, stable=True).indices]
    lengths = torch.bincount(idx, minlength=n)
    return torch.segment_reduce(vals, op, lengths=lengths, axis=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [None, 1, 6, 128])
@pytest.mark.parametrize("is_sorted", [False, True])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_searchsorted_offsets_keep_the_bits(op, is_sorted, cols, dtype):
    idx, vals = index(0, is_sorted), values(0, cols, dtype)
    fn = segment_sum if op == "sum" else segment_max
    got = fn(idx, vals, N, is_sorted=is_sorted)
    want = sort_bincount(idx, vals, N, op, is_sorted)
    assert got.shape == want.shape == (N,) + vals.shape[1:]
    assert got.dtype == dtype and torch.equal(got, want)
    empty = torch.bincount(idx, minlength=N) == 0
    fill = 0.0 if op == "sum" else float("-inf")
    assert bool((got[empty] == fill).all())


@pytest.mark.parametrize("op", ["sum", "max"])
def test_no_rows_gives_empty_segments(op):
    got = getattr(Segments(torch.zeros(0, dtype=torch.long), N), op)(
        torch.zeros((0, 6)))
    fill = 0.0 if op == "sum" else float("-inf")
    assert got.shape == (N, 6) and bool((got == fill).all())


@pytest.mark.parametrize("is_sorted", [False, True])
def test_offsets_are_the_segment_starts(is_sorted):
    idx = index(1, is_sorted)
    segs = Segments(idx, N, is_sorted)
    counts = torch.bincount(idx, minlength=N)
    assert segs.offsets.tolist() == [0] + counts.cumsum(0).tolist()
    assert (segs.order is None) == is_sorted
    if not is_sorted:
        assert torch.equal(segs.order, torch.sort(idx, stable=True).indices)


@pytest.mark.parametrize("cols", [1, 6, 128])
@pytest.mark.parametrize("is_sorted", [False, True])
def test_sums_equal_index_add_and_jax_bit_for_bit(is_sorted, cols):
    idx, vals = index(2, is_sorted), values(2, cols)
    got = segment_sum(idx, vals, N, is_sorted=is_sorted)
    assert torch.equal(got, torch.zeros((N, cols)).index_add_(0, idx, vals))
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(vals.numpy()),
                                          jnp.asarray(idx.numpy()),
                                          num_segments=N))
    np.testing.assert_array_equal(got.numpy(), want)


def test_maxima_equal_jax():
    idx, vals = index(3, False), values(3, 6)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(vals.numpy()),
                                          jnp.asarray(idx.numpy()),
                                          num_segments=N))
    np.testing.assert_array_equal(segment_max(idx, vals, N).numpy(), want)


@pytest.mark.parametrize("op", ["sum", "max"])
def test_kernel_path_gradients_equal_segment_reduce(monkeypatch, op):
    """The autograd wrapper the card runs (`_SegmentReduce`, the kernel
    replaced by its plain version) gives segment_reduce's gradients: a
    maximum's positive gradient split evenly among ties, a negative one
    not (segment_reduce's rule)."""
    monkeypatch.setattr(region, "segment_reduce_cuda",
                        region.segment_reduce_plain)
    idx = index(4, False)
    vals = values(4, 6).round()              # integers: ties in the maxima
    g_out = values(5, 6)[:N]
    segs = Segments(idx, N)
    got_v = vals.clone().requires_grad_(True)
    region._SegmentReduce.apply(got_v, segs, op).backward(g_out)
    want_v = vals.clone().requires_grad_(True)
    segment_reduce_plain(want_v, segs, op).backward(g_out)
    assert torch.equal(got_v.grad, want_v.grad)


def test_kernel_wrapper_raises_on_cpu_tensors():
    idx, vals = index(5, True), values(5, 6)
    with pytest.raises(ValueError, match="CUDA"):
        region.segment_reduce_cuda(vals, Segments(idx, N, True), "sum")


def test_spmm_plan_keeps_its_fallback_sort():
    r = np.random.RandomState(9)
    n = 96
    src = r.randint(0, n, 500)
    dst = r.randint(0, n, 500)
    w = r.rand(500).astype(np.float32)
    plan = spmm_plan(src, dst, w, n, block_rows=16, window=32)
    assert plan.fb_src.numel() > 0
    segs = plan.fallback_segments()
    assert plan.fallback_segments() is segs
    x = torch.from_numpy(r.randn(n, 8).astype(np.float32))
    out = banded_spmm(x, plan)
    xf = torch.nn.functional.pad(x, (0, 0, 0, plan.n_nodes - n))
    want = segment_sum(
        torch.cat([torch.arange(plan.n_nodes), plan.fb_dst]),
        torch.cat([gt.ops.spmm.banded_spmm_plain(x, plan.band),
                   xf[plan.fb_src] * plan.fb_weight[:, None]]),
        plan.n_nodes)[:n]
    assert torch.equal(out, want)


# -- the sharded aggregation, against the module before this change ---------

def old_sharded_scatter_add(mesh, n_nodes, halo="xla"):
    """parallel/partition.py's aggregation as it was, with index_add_."""
    def agg(x, src, dst, mask):
        xs = list(x.split(n_nodes // mesh.size))
        if halo == "pallas_ring":
            fulls = ring_all_gather(xs, mesh)
        else:
            fulls = [torch.cat(xs) for _ in xs]
        block = xs[0].shape[0]
        outs = []
        for i, (x_full, s, d, m) in enumerate(zip(
                fulls, src.chunk(mesh.size), dst.chunk(mesh.size),
                mask.chunk(mesh.size))):
            base = i * block
            in_block = ((d >= base) & (d < base + block)).float()
            msgs = x_full[s].float() * m[:, None] * in_block[:, None]
            local_dst = (d - base).clamp(0, block - 1)
            out = torch.zeros((block, x.shape[1]), dtype=torch.float32,
                              device=x.device).index_add_(0, local_dst, msgs)
            outs.append(out.to(x.dtype))
        return torch.cat(outs)
    return agg


def old_ring_scatter_add(mesh, n_nodes):
    def agg(x, src2d, dst2d, mask2d):
        xs = list(x.split(n_nodes // mesh.size))
        n, block = mesh.size, xs[0].shape[0]
        outs = []
        for i in range(n):
            acc = torch.zeros((block, x.shape[1]), dtype=torch.float32,
                              device=x.device)
            for s in range(n):
                j = (i - s) % n
                msgs = (xs[j][src2d[i, j].long().clamp(0, block - 1)].float()
                        * mask2d[i, j][:, None])
                acc = acc.index_add(0, dst2d[i, j].long().clamp(0, block - 1),
                                    msgs)
            outs.append(acc.to(x.dtype))
        return torch.cat(outs)
    return agg


RANKS, NODES, EDGES, WIDTH = 4, 64, 400, 8


def sharded_case():
    r = np.random.RandomState(10)
    src = r.randint(0, NODES, EDGES)
    dst = np.clip(src + r.randint(-12, 12, EDGES), 0, NODES - 1)
    mask = ((r.rand(EDGES) > 0.2) * r.rand(EDGES)).astype(np.float32)
    x0 = torch.from_numpy(r.randn(NODES, WIDTH).astype(np.float32))
    w0 = torch.from_numpy(r.randn(WIDTH, WIDTH).astype(np.float32) / 3)
    c = torch.from_numpy(r.randn(NODES, WIDTH).astype(np.float32))
    return src, dst, mask, x0, w0, c


def run_agg(make, method):
    """(output, dL/dW) of L = sum(agg(tanh(x0 W)) * c)."""
    src, dst, mask, x0, w0, c = sharded_case()
    mesh = make_graph_mesh(RANKS, device="cpu")
    part = (partition.partition_edges_2d if method == "ring"
            else partition.partition_edges_by_dst)
    ps, pd, pw = (torch.as_tensor(a) for a in part(src, dst, mask, NODES,
                                                   RANKS))
    if method != "ring":
        ps, pd = ps.long(), pd.long()
    agg = make(mesh, NODES)
    w = w0.clone().requires_grad_(True)
    out = agg(torch.tanh(x0 @ w), ps, pd, pw)
    (out * c).sum().backward()
    return out.detach(), w.grad


@pytest.mark.parametrize("method", ["xla", "pallas_ring", "ring"])
def test_sharded_outputs_and_gradients_keep_their_bits(method):
    """Outputs bit for bit the index_add_ version's, and so the gradients
    of the ring halo and of the ring method.  The plain halo's gradient
    now sums the ranks' copies in K3's order: it equals the old ring
    halo's bit for bit."""
    if method == "ring":
        new = run_agg(partition.ring_scatter_add, method)
        old = run_agg(old_ring_scatter_add, method)
        old_grad = old[1]
    else:
        new = run_agg(lambda m, n: partition.sharded_scatter_add(
            m, n, halo=method), method)
        old = run_agg(lambda m, n: old_sharded_scatter_add(m, n, method),
                      method)
        old_grad = run_agg(lambda m, n: old_sharded_scatter_add(
            m, n, "pallas_ring"), method)[1]
    assert torch.equal(new[0], old[0])
    assert torch.equal(new[1], old_grad)


def test_kept_segments_give_the_same_bits():
    src, dst, mask, x0, _, _ = sharded_case()
    mesh = make_graph_mesh(RANKS, device="cpu")
    ps, pd, pw = (torch.as_tensor(a) for a in partition.partition_edges_by_dst(
        src, dst, mask, NODES, RANKS))
    agg = partition.sharded_scatter_add(mesh, NODES)
    segs = partition.shard_segments(mesh, NODES, pd.long())
    assert torch.equal(agg(x0, ps.long(), pd.long(), pw, segs),
                       agg(x0, ps.long(), pd.long(), pw))
    s2, d2, w2 = (torch.as_tensor(a) for a in partition.partition_edges_2d(
        src, dst, mask, NODES, RANKS))
    ring = partition.ring_scatter_add(mesh, NODES)
    assert torch.equal(ring(x0, s2, d2, w2,
                            partition.ring_segments(mesh, NODES, d2)),
                       ring(x0, s2, d2, w2))


def test_plain_all_gather_is_the_ring_s_function():
    r = np.random.RandomState(11)
    blocks = [torch.from_numpy(r.randn(5, 3).astype(np.float32))
              .requires_grad_(True) for _ in range(RANKS)]
    mesh = make_graph_mesh(RANKS, device="cpu")
    gs = [torch.from_numpy(r.randn(RANKS * 5, 3).astype(np.float32))
          for _ in range(RANKS)]
    grads = []
    for fn in (plain_all_gather, lambda b: ring_all_gather(b, mesh)):
        outs = fn(blocks)
        assert all(torch.equal(o, torch.cat(blocks).detach()) for o in outs)
        grads.append(torch.autograd.grad(outs, blocks, gs))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_halos_give_the_same_parameter_gradients():
    """ResGCNNet through mesh_aggregators: the plain halo's parameter
    gradients equal the ring halo's bit for bit."""
    r = np.random.RandomState(12)
    n, e = 200, 1500
    src = r.randint(0, n, e)
    dst = np.clip(src + r.randint(-30, 30, e), 0, n - 1)
    mask = (src != dst).astype(np.float32)
    g = gt.make_graph_batch(r.randn(1, n, 19), src[None], dst[None],
                            r.rand(1, e, 5), np.ones((1, n)), mask[None],
                            device="cpu")
    c = torch.from_numpy(r.randn(1, n, 3).astype(np.float32))
    grads = {}
    for halo in ("xla", "pallas_ring"):
        model = gt.ResGCNNet(hidden_channels=16, n_layers=2,
                             generator=torch.Generator().manual_seed(0))
        aggs = gt.mesh_aggregators(make_graph_mesh(RANKS, device="cpu"),
                                   src, dst, mask, n, method="allgather",
                                   halo=halo)
        (model(g, aggregators=aggs) * c).sum().backward()
        grads[halo] = {k: p.grad for k, p in model.named_parameters()}
    assert grads["xla"].keys() == grads["pallas_ring"].keys()
    for k, v in grads["xla"].items():
        assert torch.equal(v, grads["pallas_ring"][k]), k
