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


# -- the kernel's exactness rule and its host-side arithmetic --------------

def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching any NaN; +0 and -0 differ."""
    na, nb = a.isnan(), b.isnan()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints))


TINY = {torch.float32: 1e-45, torch.float64: 5e-324, torch.bfloat16: 9.2e-41,
        torch.float16: 6e-8}


def identity_heavy(seed: int, dtype, op: str) -> torch.Tensor:
    """(P, 6) values, most of them the op's identity (+-0 for a sum, -inf
    for a maximum), the rest normal, subnormal (+-), +-inf, NaN or the
    other signed zero."""
    r = np.random.RandomState(200 + seed)
    ident = (np.where(r.rand(P, 6) < 0.5, 0.0, -0.0) if op == "sum"
             else np.full((P, 6), -np.inf))
    pick = r.rand(P, 6)
    live = r.rand(P, 1) < 0.4
    v = np.where(live & (pick < 0.4), r.randn(P, 6) * 3, ident)
    v = np.where(live & (pick > 0.8), TINY[dtype] * r.choice([-1, 1], (P, 6)),
                 v)
    v = np.where(live & (pick > 0.97), r.choice([np.inf, -np.inf, np.nan,
                                                 0.0, -0.0], (P, 6)), v)
    return torch.from_numpy(v).to(dtype)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_identity_rows_leave_a_chain_with_the_same_bits(dtype, op, seed):
    """The rule the kernel's long blocks rest on: a row whose values in a
    chain's columns are all +-0 (for a sum) or all -inf (for a maximum)
    can be left out of the chain, at every dtype, with the plain version's
    bits; checked for the whole row and for a group of two columns."""
    idx, vals = index(seed, seed % 2 == 0), identity_heavy(seed, dtype, op)
    want = segment_reduce_plain(vals, Segments(idx, N, seed % 2 == 0), op)
    ident = 0.0 if op == "sum" else float("-inf")
    for cols in (slice(None), slice(2, 4)):
        live = (vals[:, cols] != ident).any(dim=1)
        got = segment_reduce_plain(vals[live], Segments(idx[live], N), op)
        assert bool((~live).sum() > P // 4)
        assert same_bits(got[:, cols], want[:, cols])


@pytest.mark.parametrize(
    "shape,want",
    # (rows, cols, n, element bytes, aligned) ->
    # (vec, cv, groups, tile, tiles, long blocks, short blocks)
    [((160_000, 128, 10_000, 4, True), (4, 32, 16, 256, 625, 1250, 1250)),
     ((160_000, 65, 10_000, 4, True), (1, 65, 9, 256, 625, 704, 2540)),
     ((160_000, 8, 10_000, 4, True), (4, 2, 1, 1024, 157, 20, 79)),
     ((160_000, 1, 5_177_344, 4, True), (1, 1, 1, 1024, 157, 20, 20224)),
     ((2_359_296, 15, 10_000, 4, True), (1, 15, 2, 1024, 2304, 576, 586)),
     ((2_359_296, 3, 2_359_296, 4, True), (1, 3, 1, 1024, 2304, 288, 27648)),
     ((27_333, 128, 2_500, 4, True), (4, 32, 16, 256, 107, 214, 313)),
     ((160_000, 128, 10_000, 2, True), (8, 16, 8, 256, 625, 625, 625)),
     ((160_000, 128, 10_000, 4, False), (1, 128, 16, 256, 625, 1250, 5000)),
     ((200, 6, 40, 8, True), (2, 3, 2, 1024, 1, 0, 1))])
def test_kernel_plan(shape, want):
    """Vectors, column groups, the tile by the row's bytes, tiles, the long
    blocks (none when no segment can be long) and the per-thread blocks."""
    plan = region.kernel_plan(*shape)
    assert (plan.vec, plan.cv, plan.groups, plan.tile, plan.tiles,
            plan.long_blocks, plan.short_blocks) == want
    assert plan.gv * plan.vec * shape[3] == region.GROUP_BYTES
    rows = shape[0]
    if plan.long_blocks:
        assert plan.keep == plan.groups * rows
        assert plan.count == plan.done == plan.groups * plan.tiles
        assert plan.long_blocks * region.UNITS >= plan.tiles * plan.groups
    else:
        assert plan.keep == plan.count == plan.done == 0


@pytest.mark.parametrize("cols,elt,tile", [(64, 4, 256), (63, 4, 1024),
                                            (32, 8, 256), (127, 2, 1024)])
def test_kernel_plan_tile_follows_the_row_bytes(cols, elt, tile):
    """Rows of WIDE_ROW_BYTES or more take TILE_WIDE, narrower ones
    TILE_NARROW; with fewer rows than the tile no segment can be long."""
    plan = region.kernel_plan(5000, cols, 10, elt, True)
    assert plan.tile == tile and plan.long_blocks > 0
    assert region.kernel_plan(tile - 1, cols, 10, elt, True).long_blocks == 0


@pytest.mark.parametrize("op", ["sum", "max"])
def test_a_strided_sorted_index_is_kept_contiguous(op):
    """A sorted index that is a strided view (a column of an edge list)
    is kept as a contiguous int64 `ordered`, which the kernel reads as a
    dense array, with the same sums."""
    idx = long_index(32)
    edges = torch.stack([torch.zeros_like(idx), idx], 1)
    assert not edges[:, 1].is_contiguous()
    segs = Segments(edges[:, 1], N, is_sorted=True)
    assert segs.ordered.is_contiguous() and segs.ordered.dtype == torch.int64
    vals = torch.from_numpy(np.random.RandomState(3).randn(P, 6)
                            .astype(np.float32))
    assert same_bits(segs.sum(vals) if op == "sum" else segs.max(vals),
                     segment_reduce_plain(vals, Segments(idx, N, True), op))


def long_index(tile: int) -> torch.Tensor:
    """P rows into N segments: a long one at a tile's first row, one of
    exactly a tile and one a row short, around short and empty ones."""
    lengths = np.zeros(N, np.int64)
    lengths[[0, 2, 5, 6, 9]] = [tile, 7, tile - 1, 3, 0]
    lengths[39] = P - lengths.sum()
    return torch.from_numpy(np.repeat(np.arange(N), lengths))


def test_long_segments_are_those_of_a_tile_or_more():
    tile = 32
    segs = Segments(long_index(tile), N, is_sorted=True)
    lengths = segs.offsets.diff()
    want = lengths >= tile
    assert torch.equal(region.long_segments(segs.offsets, tile), want)
    assert want[0] and not want[5] and not want[9] and not want[1]
    assert want.sum() == 2 and lengths[39] == P - 2 * tile - 9


def max_after(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's join of the maxima of two consecutive runs of rows."""
    return torch.where(b.isnan(), b, torch.where(a.isnan(), a,
                                                 torch.where(a < b, b, a)))


def model_walk(ordered, offsets, values, tile: int, n: int):
    """A sum's long blocks in plain Python: each tile keeps, in order, its
    rows of the long segments of its first and last rows that are not
    identity rows, counted for each of the two; each long segment's chain
    then reads its tiles' entries (in its first tile the second segment's,
    if it starts inside it).  Returns {segment: rows of its chain}; checks
    that each long segment's counter counts its tiles."""
    rows = ordered.numel()
    tiles = -(-rows // tile)
    live = (values.reshape(rows, -1) != 0).any(dim=1)
    seg_len = offsets.diff()
    keep, counts, units = {}, {}, {}
    for t in range(tiles):
        p0, pe = t * tile, min(rows, (t + 1) * tile)
        s0, s1 = int(ordered[p0]), int(ordered[pe - 1])
        long0 = seg_len[s0] >= tile
        long1 = s1 != s0 and seg_len[s1] >= tile
        e0 = min(int(offsets[s0 + 1]), pe) if long0 else p0
        b1 = int(offsets[s1]) if long1 else pe
        kept = [p for p in range(p0, pe)
                if (p < e0 or b1 <= p < pe) and live[p]]
        keep[t] = kept
        counts[t] = (sum(p < e0 for p in kept), sum(p >= b1 for p in kept))
        for s, is_long in ((s0, long0), (s1, long1)):
            if is_long:
                units[s] = units.get(s, 0) + 1
    chains = {}
    for s in range(n):
        if seg_len[s] < tile:
            continue
        lo, hi = int(offsets[s]), int(offsets[s + 1])
        chain = []
        for t in range(lo // tile, (hi - 1) // tile + 1):
            c0, c1 = counts[t]
            second = t == lo // tile and lo != t * tile
            chain += keep[t][c0:c0 + c1] if second else keep[t][:c0]
        chains[s] = chain
        assert units[s] == (hi - 1) // tile - lo // tile + 1
    return chains


def long_case(tile: int, op: str, dtype=torch.float32):
    """long_index(tile) with more long segments deep in the rows, sorted,
    and identity-heavy values."""
    idx = long_index(tile)
    idx[150:] = torch.from_numpy(np.random.RandomState(7).randint(12, N,
                                                                P - 150))
    return (Segments(torch.sort(idx)[0], N, is_sorted=True),
            identity_heavy(1, dtype, op))


@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tiles_hand_each_long_segment_its_chain(tile):
    """A sum's tiles' kept rows and counts, read as the long blocks read
    them, give each long segment exactly its non-identity rows in
    ascending order, every tile of it counted once; and its sum over them
    is the plain version's, bit for bit."""
    segs, vals = long_case(tile, "sum")
    chains = model_walk(segs.ordered, segs.offsets, vals, tile, N)
    live = (vals != 0).any(dim=1)
    want = segment_reduce_plain(vals, segs, "sum")
    assert chains
    for s, chain in chains.items():
        lo, hi = int(segs.offsets[s]), int(segs.offsets[s + 1])
        assert chain == [p for p in range(lo, hi) if live[p]]
        got = segment_reduce_plain(vals[chain], Segments(
            torch.zeros(len(chain), dtype=torch.long), 1), "sum")
        assert same_bits(got[0], want[s])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_tiles_maxima_joined_in_order_give_the_chain(tile, dtype):
    """A maximum's long blocks: each tile's part of a long segment reduced
    alone, in 32-row runs joined in row order, then the tiles' maxima
    joined in order: the plain version's bits, NaN, +-0 and -inf
    included."""
    segs, vals = long_case(tile, "max", dtype)
    vals = vals.float() if dtype != torch.float64 else vals
    want = segment_reduce_plain(vals, segs, "max")
    lengths = segs.offsets.diff()
    for s in torch.nonzero(lengths >= tile).reshape(-1).tolist():
        lo, hi = int(segs.offsets[s]), int(segs.offsets[s + 1])
        acc = torch.full(vals.shape[1:], float("-inf"), dtype=vals.dtype)
        for t in range(lo // tile, (hi - 1) // tile + 1):
            part = torch.full_like(acc, float("-inf"))
            a, b = max(lo, t * tile), min(hi, (t + 1) * tile)
            for r0 in range(a, b, 32):
                run = torch.full_like(acc, float("-inf"))
                for p in range(r0, min(b, r0 + 32)):
                    run = max_after(run, vals[p])
                part = max_after(part, run)
            acc = max_after(acc, part)
        assert same_bits(acc, want[s])


def test_done_counters_are_zero_and_kept_per_stream():
    """The long blocks' buffers: one per (device, stream) and store, zero
    when made, reused while large enough, grown at least twofold."""
    cpu = torch.device("cpu")
    for store in (region._DONE, region._WORK):
        store.clear()
        a = region._stream_buffer(store, cpu, 1, 10)
        assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
        assert region._stream_buffer(store, cpu, 1, 5) is a
        b = region._stream_buffer(store, cpu, 2, 5)
        assert b is not a
        c = region._stream_buffer(store, cpu, 1, 11)
        assert c.numel() >= 20 and not c.any()
        store.clear()
    assert region._stream_buffer(region._DONE, cpu, 1, 4) is not \
        region._stream_buffer(region._WORK, cpu, 1, 4)
    region._DONE.clear()
    region._WORK.clear()
