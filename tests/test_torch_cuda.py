"""Tests that need an NVIDIA GPU and nvcc: the hand-written kernels against
their plain versions, and the port's pipeline and graph-sharded model on the
card against their CPU paths.  Each skips without CUDA.  The file imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gcn_grabcut_torch as gt
from gcn_grabcut_torch.ops import maxflow, region, spmm
from gcn_grabcut_torch.parallel import ring

pytestmark = pytest.mark.cuda

SPMM_TOL = 1e-4   # same products as the plain version, fp32 sums reordered


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def banded_plan(n, dtype, device, seed=9, block_rows=128, window=512):
    r = np.random.RandomState(seed)
    src = r.randint(0, n, 6 * n)
    dst = np.clip(src + r.randint(-200, 200, src.size), 0, n - 1)
    src = np.concatenate([src, r.randint(0, n, n // 10)])
    dst = np.concatenate([dst, r.randint(0, n, n // 10)])
    w = r.rand(src.size).astype(np.float32)
    plan = spmm.spmm_plan_device(
        torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
        torch.from_numpy(w).to(device), n, block_rows=block_rows,
        window=window, dtype=dtype)
    return plan, (src, dst, w)


# (n, R, window): K = window / R rounded up.  n < n_pad exercises the
# kernel's row guard, odd K the default window's layout.
SPMM_LAYOUTS = [(1000, 128, 512), (1000, 128, 640), (1024, 64, 256),
                (1000, 256, 1280), (1024, 256, 1024)]


@pytest.mark.parametrize("layout", SPMM_LAYOUTS,
                         ids=lambda l: "n{}-R{}-w{}".format(*l))
@pytest.mark.parametrize("d", [16, 19, 128, 200, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_spmm_kernel_matches_plain(cuda, dtype, d, layout):
    """Every tile width (64 / 128 / 256 columns), the narrow variant (rows
    of D = 19 are not 16-byte multiples), ragged D, R = 64 / 128 / 256,
    even and odd K, n below and at n_pad."""
    n, block_rows, window = layout
    plan, _ = banded_plan(n, dtype, cuda, block_rows=block_rows,
                          window=window)
    assert plan.n_nodes == 1024
    x = torch.randn(n, d, device=cuda).to(dtype)
    before = spmm.banded_spmm.kernel_launches
    out = spmm.banded_spmm_cuda(x, plan.band)
    torch.cuda.synchronize()
    assert spmm.banded_spmm.kernel_launches == before + 1
    ref = spmm.banded_spmm_plain(x, plan.band)
    assert out.shape == ref.shape == (plan.n_nodes, d)
    assert float((out - ref).abs().max()) <= SPMM_TOL * max(
        1.0, float(ref.abs().max()))


def test_banded_spmm_on_card_matches_oracle(cuda):
    n = 1000
    plan, (src, dst, w) = banded_plan(n, torch.float32, cuda, seed=3)
    assert bool((plan.fb_weight != 0).any())    # the fallback has work
    x = torch.randn(n, 64, device=cuda)
    out = spmm.banded_spmm(x, plan)
    ref = spmm.spmm_reference(x, src, dst, w, n)
    torch.testing.assert_close(out, ref, atol=SPMM_TOL, rtol=SPMM_TOL)


def test_banded_spmm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    band = torch.zeros(4, 256, 128, device=cuda)
    with pytest.raises(TypeError):
        spmm.banded_spmm_cuda(torch.zeros(200, 16, device=cuda,
                                          dtype=torch.bfloat16), band)
    with pytest.raises(ValueError, match="unsupported shapes"):
        spmm.banded_spmm_cuda(torch.zeros(200, 16, device=cuda),
                              torch.zeros(4, 256, 32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm.banded_spmm_cuda(torch.zeros(16, 200, device=cuda).T, band)


def test_segment_batch_on_card_matches_cpu(cuda):
    """The port at 320² / 2600 superpixels (K = 2601: the large path) on
    the card and on the CPU, same weights: posteriors within the bf16
    tolerance, trimaps equal but for near-threshold pixels, one kernel
    launch per propagation, and B=2 equal to two B=1 runs."""
    r = np.random.RandomState(5)
    yy, xx = np.mgrid[0:320, 0:320]
    imgs = []
    for c in ((160, 150), (120, 200)):
        img = (r.rand(320, 320, 3) * 80).astype(np.uint8)
        blob = ((yy - c[0]) ** 2 + (xx - c[1]) ** 2) < 90 ** 2
        img[blob] = (200 + r.rand(blob.sum(), 3) * 50).astype(np.uint8)
        imgs.append(img)
    cfg = gt.SuperpixelGraphConfig(n_segments=2600)

    def model():
        return gt.ResGCNNet(hidden_channels=16, n_layers=2,
                            generator=torch.Generator().manual_seed(1))

    card = gt.GCNGrabCutPipeline(model(), cfg, device=cuda)
    spmm.banded_spmm.kernel_launches = 0
    on_card = card.segment_batch(imgs)
    assert spmm.banded_spmm.kernel_launches == 2 * 3   # (2 GCN + 1 SAGE)/img
    on_cpu = gt.GCNGrabCutPipeline(model(), cfg, device="cpu"
                                   ).segment_batch(imgs[:1])[0]
    np.testing.assert_allclose(on_card[0].probs, on_cpu.probs, atol=1e-3)
    assert float((on_card[0].trimap == on_cpu.trimap).mean()) >= 0.999
    single = card.segment_batch(imgs[1:])[0]
    np.testing.assert_array_equal(on_card[1].segments, single.segments)
    # index_add_ adds in no fixed order on CUDA; a last-ulp change can move
    # a value across a bf16 rounding boundary in the forward.
    np.testing.assert_allclose(on_card[1].probs, single.probs, atol=1e-3)
    assert 0.0 < on_card[0].binary_mask.mean() < 1.0


def test_segment_batch_times_its_stages_by_events(cuda, monkeypatch):
    """On the card a batch's stage times come from CUDA events read after
    the pull: `_dispatch_batch` calls no synchronize, and the four stages
    fit inside the batch's wall time."""
    import time
    r = np.random.RandomState(3)
    imgs = [(r.rand(96, 96, 3) * 255).astype(np.uint8) for _ in range(2)]
    pipe = gt.GCNGrabCutPipeline(
        gt.ResGCNNet(hidden_channels=16, n_layers=2,
                     generator=torch.Generator().manual_seed(1)),
        gt.SuperpixelGraphConfig(n_segments=100), device=cuda)
    pipe.segment_batch(imgs)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a host sync in _dispatch_batch")

    t = time.perf_counter()
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "synchronize", refuse)
        handle = pipe._dispatch_batch(
            imgs, threshold_fg=0.55, threshold_bg=0.55,
            min_area_ratio=0.002, keep_largest=False, filter_radius=8,
            want_segments=True)
    timing = pipe._finalize_batch(handle)[0].timing
    wall = time.perf_counter() - t
    assert list(timing) == ["graph_build", "gcn_inference", "grabcut",
                            "postprocess"]
    assert all(v > 0 for v in timing.values())
    assert sum(timing.values()) <= wall


def test_dense_ensemble_path_on_card_matches_cpu(cuda):
    """The recommended configuration (3-seed bgc ensemble, 500 superpixels,
    geodesic prior, ms_scales (1.0, 0.75)) at 128 px (K = 484) on the card
    and on the CPU: no SpMM launch, fp32 posteriors within 1e-4, trimaps
    equal but for near-threshold pixels."""
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = ",".join(str(root / f"examples/ensemble_r5/bgc_s4{i}.msgpack")
                    for i in (2, 3, 4))
    # Textured everywhere: a flat-colour region's std-Lab feature is
    # E[x^2] - E[x]^2 cancelling to rounding noise, which the card's sums
    # round differently (the JAX package has the same fragility).
    r = np.random.RandomState(3)
    yy, xx = np.mgrid[0:128, 0:128]
    img = 60 + r.rand(128, 128, 3) * 40
    disc = ((yy - 64) ** 2 + (xx - 60) ** 2) < 35 ** 2
    img[disc] = (190, 70, 50) + r.rand(int(disc.sum()), 3) * 30
    img = img.astype(np.uint8)
    cfg = gt.SuperpixelGraphConfig(n_segments=500, bg_connectivity=True)
    kw = dict(threshold_fg=0.65, threshold_bg=0.65, filter_radius=4,
              ms_scales=(1.0, 0.75))
    runs = []
    for dev in (cuda, "cpu"):
        model, meta = gt.load_model_auto(spec, device=dev)
        assert meta["ensemble_size"] == 3
        spmm.banded_spmm.kernel_launches = 0
        runs.append(gt.GCNGrabCutPipeline(model, cfg, device=dev)
                    .segment_batch([img, img], **kw))
        assert spmm.banded_spmm.kernel_launches == 0
    on_card, on_cpu = runs
    np.testing.assert_array_equal(on_card[0].segments, on_cpu[0].segments)
    np.testing.assert_allclose(on_card[0].probs, on_cpu[0].probs, atol=1e-4)
    np.testing.assert_allclose(on_card[1].probs, on_card[0].probs, atol=1e-4)
    assert float((on_card[0].trimap == on_cpu[0].trimap).mean()) >= 0.999
    assert 0.0 < on_card[0].binary_mask.mean() < 1.0


def test_lock_step_grabcut_on_card_matches_loop(cuda):
    """The lock-step batched GrabCut on the card gives each image the
    mask of its own solve (the image-by-image plain version), bit for
    bit, with a one-sided trimap in the batch."""
    from gcn_grabcut_torch import grabcut as gc
    r = np.random.RandomState(4)
    yy, xx = np.mgrid[0:96, 0:96]
    imgs, tris = [], []
    for b in range(3):
        d2 = ((yy - 48 - 4 * b) / 30) ** 2 + ((xx - 44 + 3 * b) / 26) ** 2
        img = r.rand(96, 96, 3) * 70 + 20 + 20 * b
        img[d2 < 1] = 150 + r.rand(int((d2 < 1).sum()), 3) * 100
        tri = np.zeros((96, 96), np.uint8)
        tri[d2 < 1.8] = 2
        tri[d2 < 1.1] = 3
        tri[d2 < 0.15] = 1
        imgs.append(img.astype(np.uint8))
        tris.append(tri)
    tris[1][:] = 3
    rgb = torch.as_tensor(np.stack(imgs), device=cuda).float()
    tri = torch.as_tensor(np.stack(tris), device=cuda)
    lock = gc.grabcut_batch_device(rgb, tri)
    assert torch.equal(lock, gc.grabcut_batch_loop(rgb, tri))
    assert bool((lock[1] == 1).all())
    assert 0.0 < float(lock[0].float().mean()) < 1.0


# ------------------------------------------------------------- the min-cut

# Each case: connectivity, which of mincut_lattices' images, the solve's
# options, whether it resumes from a first solve's flow, and the lattice's
# (H, W).  The images converge after 0, a few and many rounds; max_outer
# and relabel_iters bind in their cases.  The border cases put the
# kernel's tiles (32 x 32 a sweep, 32 x 64 a relax) across the image's
# edges at shapes that are no multiple of them, one lattice thinner than a
# tile's halo; unroll6 runs a relax block as two sub-blocks; signed-zeros
# hands the solve -0 for every zero of its planes, which the plain
# version's adds of +0 turn into +0 in every sweep, over one round in which
# the kernel skips the quiet tiles far from the strips.
# tests/test_torch_mincut_kernel.py holds the plain version to the JAX
# package on the same cases.
MINCUT_KW = dict(sweeps_per_round=8, unroll=2)
MINCUT_CASES = {
    "conn8": (8, (1,), MINCUT_KW, False, (40, 44)),
    "conn4": (4, (1, 2), MINCUT_KW, False, (40, 44)),
    "lock-step": (8, (0, 1, 2), MINCUT_KW, False, (40, 44)),
    "carried": (8, (0, 1, 2), MINCUT_KW, True, (40, 44)),
    "max-outer": (8, (0, 1, 2), dict(MINCUT_KW, max_outer=2), False,
                  (40, 44)),
    "relabel-iters": (4, (0, 1, 2), dict(MINCUT_KW, relabel_iters=3), False,
                      (40, 44)),
    "unroll1-odd": (8, (1, 2), dict(sweeps_per_round=5, unroll=1), False,
                    (37, 41)),
    "border-37x67": (8, (0, 1, 2), MINCUT_KW, False, (37, 67)),
    "border-conn4": (4, (1, 2), MINCUT_KW, False, (37, 67)),
    "thin-3-rows": (8, (1, 2), MINCUT_KW, False, (3, 67)),
    "unroll6": (8, (1, 2), dict(sweeps_per_round=12, unroll=6), False,
                (40, 44)),
    "signed-zeros": (8, (0, 2), dict(MINCUT_KW, max_outer=1), False,
                     (40, 140)),
}


def mincut_lattices(seed=0, h=40, w=44):
    """Three lattices: one with no excess to push (converged before its
    first round), a short one, and a long one (a source strip and a sink
    strip at opposite edges over weak capacities); excess (3, h, w) and
    four capacity planes (3, h, w) of OFFSETS_8, float32 numpy."""
    r = np.random.RandomState(seed)
    ex = np.stack([-np.abs(r.randn(h, w)) - 0.1, r.randn(h, w) * 2,
                   np.zeros((h, w))]).astype(np.float32)
    ex[2, :, :4] = 40.0
    ex[2, :, -4:] = -40.0
    caps = np.stack([r.rand(3, h, w) for _ in maxflow.OFFSETS_8]
                    ).astype(np.float32)
    caps[:, 2] *= 0.5
    return ex, caps


def mincut_case(name):
    """(excess, r_fwd, r_bwd, connectivity, options) of a case as CPU
    tensors.  A carried case resumes from the plain version's first solve
    with a seeded terminal delta on every image but the first."""
    conn, images, kw, carried, (h, w) = MINCUT_CASES[name]
    ex, caps = mincut_lattices(h=h, w=w)
    offsets = maxflow.OFFSETS_8 if conn == 8 else maxflow.OFFSETS_4
    ex = torch.from_numpy(ex[list(images)])
    r_fwd = tuple(maxflow._zero_border(torch.from_numpy(c[list(images)]),
                                       dy, dx)
                  for c, (dy, dx) in zip(caps, offsets))
    r_bwd = r_fwd
    if carried:
        _, e1, r_fwd, r_bwd = maxflow.grid_mincut_plain(ex, r_fwd, r_bwd,
                                                        conn, **kw)
        delta = np.random.RandomState(1).randn(*ex.shape).astype(np.float32)
        delta[0] = 0.0
        ex = e1 + torch.from_numpy(delta)
        r_fwd = tuple(r.contiguous() for r in r_fwd)
        r_bwd = tuple(r.contiguous() for r in r_bwd)
    if name == "signed-zeros":
        def negate_zeros(t):
            return torch.where(t == 0, -0.0, t)
        ex = negate_zeros(ex)
        r_fwd = tuple(negate_zeros(r) for r in r_fwd)
        r_bwd = tuple(negate_zeros(r) for r in r_bwd)
    return ex, r_fwd, r_bwd, conn, kw


@pytest.mark.parametrize("name", list(MINCUT_CASES))
def test_mincut_kernel_matches_plain_bit_for_bit(cuda, name):
    """The kernel against its plain version on the card: fg, e', both
    residual planes bit for bit, each image's rounds and the relabel
    steps; one launch, no host sync in the solve."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case(name)
    ex, r_fwd, r_bwd = (ex.to(cuda), tuple(r.to(cuda) for r in r_fwd),
                        tuple(r.to(cuda) for r in r_bwd))
    maxflow.counts.reset()
    want = maxflow.grid_mincut_plain(ex, r_fwd, r_bwd, conn, **kw)
    plain_rounds = maxflow.counts.rounds[0]
    plain_steps = maxflow.counts.relabel_steps
    maxflow.counts.reset()
    before = maxflow.grid_mincut_cuda.kernel_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = maxflow.grid_mincut_batch(ex, r_fwd, r_bwd, conn, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert maxflow.grid_mincut_cuda.kernel_launches == before + 1
    assert maxflow.counts.syncs == 0
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for a, b in zip(got[2] + got[3], want[2] + want[3]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(maxflow.counts.rounds[0], plain_rounds)
    assert maxflow.counts.relabel_steps == plain_steps


def test_mincut_kernel_leaves_its_inputs_and_repeats(cuda):
    """The caller's tensors stay unchanged, and two solves give the same
    bits."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case("lock-step")
    ex, r_fwd = ex.to(cuda), tuple(r.to(cuda) for r in r_fwd)
    keep = [t.clone() for t in (ex, *r_fwd)]
    a = maxflow.grid_mincut_batch(ex, r_fwd, r_fwd, conn, **kw)
    b = maxflow.grid_mincut_batch(ex, r_fwd, r_fwd, conn, **kw)
    for x, y in zip((ex, *r_fwd), keep):
        assert torch.equal(x, y)
    for x, y in zip((a[0], a[1], *a[2], *a[3]), (b[0], b[1], *b[2], *b[3])):
        assert torch.equal(x, y)


def test_mincut_counts_keep_no_card_memory(cuda):
    """Many kernel solves leave no CUDA tensor in `counts`, and at most
    the solves still running unread; the tallies and grid read back."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case("conn8")
    ex, r_fwd = ex.to(cuda), tuple(r.to(cuda) for r in r_fwd)
    maxflow.counts.reset()
    for _ in range(20):
        maxflow.grid_mincut_batch(ex, r_fwd, r_fwd, conn, **kw)
    torch.cuda.synchronize()
    maxflow.grid_mincut_batch(ex, r_fwd, r_fwd, conn, **kw)
    assert len(maxflow.counts._pending) <= 1
    held = [x for call in maxflow.counts._calls for x in call]
    held += [x for p in maxflow.counts._pending for x in p]
    assert not any(torch.is_tensor(x) and x.is_cuda for x in held)
    tallies = maxflow.counts.kernel_tallies
    assert len(tallies) == 21 and not maxflow.counts._pending
    assert all(t["blocks"] > 0 and t["barriers"] > 0 for t in tallies)
    assert [r.tolist() for r in maxflow.counts.rounds] == [[4]] * 21


def test_mincut_kernel_refuses_what_it_does_not_take(cuda):
    """Bad planes raise before a launch; the launch count stays."""
    ex, r_fwd, r_bwd, conn, kw = mincut_case("conn8")
    e = ex.to(cuda)
    rf = tuple(r.to(cuda) for r in r_fwd)
    before = maxflow.grid_mincut_cuda.kernel_launches
    with pytest.raises(TypeError):
        maxflow.grid_mincut_cuda(e.double(), rf, rf, conn)
    with pytest.raises(ValueError, match="contiguous"):
        maxflow.grid_mincut_cuda(e, (rf[0].transpose(1, 2).contiguous()
                                     .transpose(1, 2),) + rf[1:], rf, conn)
    with pytest.raises(ValueError, match="one CUDA device"):
        maxflow.grid_mincut_cuda(e, (rf[0].cpu(),) + rf[1:], rf, conn)
    assert maxflow.grid_mincut_cuda.kernel_launches == before


def ring_data(n, chunk, d, dtype, device, seed):
    """Fresh blocks for K2 and per-rank cotangents for K3."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n * chunk, d), generator=gen, device=device).to(dtype)
    g = torch.randn((n, n * chunk, d), generator=gen, device=device).to(dtype)
    return list(x.split(chunk)), list(g)


def assert_exact(outs, wants):
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        assert o.shape == w.shape and o.dtype == w.dtype
        assert torch.equal(o, w)


@pytest.mark.parametrize("chunk", [40, 37])
@pytest.mark.parametrize("n", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernels_match_plain(cuda, n, dtype, chunk):
    """chunk = 37 gives a vector count that the blocks per rank do not
    divide (1 184 fp32 vectors over 5 blocks, 592 bf16 over 3)."""
    mesh = gt.make_graph_mesh(n)
    blocks, gs = ring_data(n, chunk, 128, dtype, cuda, seed=n)
    k2, k3 = (ring.ring_all_gather.kernel_launches,
              ring.ring_reduce_scatter.kernel_launches)
    ag = ring.ring_all_gather_cuda(blocks, mesh)
    rs = ring.ring_reduce_scatter_cuda(gs, mesh)
    torch.cuda.synchronize()
    assert ring.ring_all_gather.kernel_launches == k2 + 1
    assert ring.ring_reduce_scatter.kernel_launches == k3 + 1
    assert_exact(ag, ring.ring_all_gather_plain(blocks))
    assert_exact(rs, ring.ring_reduce_scatter_plain(gs))


def test_back_to_back_calls_with_different_data(cuda):
    """Two calls queued with no sync between them: the second call's waits
    must not be satisfied by the first call's signal words."""
    mesh = gt.make_graph_mesh(4)
    first, second = (ring_data(4, 300, 64, torch.float32, cuda, seed=s)
                     for s in (1, 2))
    outs = [(ring.ring_all_gather_cuda(b, mesh),
             ring.ring_reduce_scatter_cuda(g, mesh)) for b, g in
            (first, second)]
    torch.cuda.synchronize()
    for (ag, rs), (b, g) in zip(outs, (first, second)):
        assert_exact(ag, ring.ring_all_gather_plain(b))
        assert_exact(rs, ring.ring_reduce_scatter_plain(g))
    assert not torch.equal(outs[0][0][0], outs[1][0][0])


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_collectives_allocate_only_their_outputs(cuda, kernel):
    """Neither kernel has receive slots or device scratch: over a call, the
    peak of the bytes requested from the allocator rises by no more than
    the outputs."""
    n = 4
    mesh = gt.make_graph_mesh(n)
    blocks, gs = ring_data(n, 300, 128, torch.float32, cuda, seed=7)
    if kernel == "K2":
        call, plain, args = (ring.ring_all_gather_cuda,
                             ring.ring_all_gather_plain, blocks)
    else:
        call, plain, args = (ring.ring_reduce_scatter_cuda,
                             ring.ring_reduce_scatter_plain, gs)
    call(args, mesh)                                     # build and warm
    torch.cuda.synchronize()
    # Bytes requested from the caching allocator, not its blocks, which it
    # rounds up and may leave unsplit.
    key = "requested_bytes.all."
    base = torch.cuda.memory_stats(cuda)[key + "current"]
    torch.cuda.reset_peak_memory_stats(cuda)
    outs = call(args, mesh)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats(cuda)[key + "peak"]
    assert peak - base <= sum(o.untyped_storage().nbytes() for o in outs)
    assert_exact(outs, plain(args))


@pytest.mark.parametrize("chunk", [4096, 16384])
def test_all_gather_slice_spanning_several_batches(cuda, chunk):
    """K2's threads copy a block's slice in batches of 8 vectors each
    (2 048 vectors a block).  At n = 2 on an H100's 132 SMs a slice is
    ~990 vectors at chunk 4 096 (2 MB) and ~3 970 at chunk 16 384, which
    takes the copy loop round twice."""
    mesh = gt.make_graph_mesh(2)
    blocks, _ = ring_data(2, chunk, 128, torch.float32, cuda, seed=chunk)
    assert_exact(ring.ring_all_gather_cuda(blocks, mesh),
                 ring.ring_all_gather_plain(blocks))


def test_ring_kernels_exact_under_skew(cuda):
    """A short stress: seeded delays, read by K2 and K3 as (rank, phase)."""
    r = np.random.RandomState(0)
    for n in (2, 4, 8):
        mesh = gt.make_graph_mesh(n)
        for i in range(10):
            blocks, gs = ring_data(n, 64, 128, torch.bfloat16, cuda,
                                   seed=100 * n + i)
            delays = r.randint(0, 20_000, (n, n)) * (r.rand(n, n) < 0.5)
            assert_exact(ring.ring_all_gather_cuda(blocks, mesh, delays),
                         ring.ring_all_gather_plain(blocks))
            assert_exact(ring.ring_reduce_scatter_cuda(gs, mesh, delays),
                         ring.ring_reduce_scatter_plain(gs))


def test_ring_wrappers_reject_what_the_kernels_do_not_take(cuda):
    mesh = gt.make_graph_mesh(4)
    with pytest.raises(ValueError, match="do not split"):
        ring.ring_reduce_scatter([torch.zeros(4 * 16 + 2, 128, device=cuda)
                                  for _ in range(4)], mesh)
    with pytest.raises(ValueError, match="multiple of 16"):
        ring.ring_all_gather_cuda([torch.zeros(3, 2, device=cuda,
                                               dtype=torch.bfloat16)] * 4,
                                  mesh)
    with pytest.raises(TypeError):
        ring.ring_all_gather_cuda([torch.zeros(4, 4, device=cuda,
                                               dtype=torch.float16)] * 4,
                                  mesh)


def test_sharded_forward_and_backward_on_card_match_cpu(cuda):
    """The graph-sharded ResGCNNet over 4 ranks with the ring halo, on the
    card and on the CPU, same weights: logits and every parameter's
    gradient of sum(logits * c), with K2 launched 3 times forward and K3 3
    times backward (2 GCN + 1 SAGE)."""
    r = np.random.RandomState(1)
    n, e = 400, 3000
    src_l = r.randint(0, n, e)
    dst_l = np.clip(src_l + r.randint(-30, 30, e), 0, n - 1)
    src = np.concatenate([src_l, dst_l])
    dst = np.concatenate([dst_l, src_l])
    mask = (src != dst).astype(np.float32)
    arrays = (r.randn(1, n, 19).astype(np.float32), src[None], dst[None],
              r.rand(1, len(src), 5).astype(np.float32),
              np.ones((1, n), np.float32), mask[None])
    c = r.randn(1, n, 3).astype(np.float32)

    def run(device):
        g = gt.make_graph_batch(*arrays, device=device)
        model = gt.ResGCNNet(hidden_channels=32, n_layers=2,
                             generator=torch.Generator().manual_seed(2)
                             ).to(device)
        aggs = gt.mesh_aggregators(gt.make_graph_mesh(4, device=device), src,
                                   dst, mask, n, method="allgather",
                                   halo="pallas_ring")
        logits = model(g, aggregators=aggs)
        k2 = ring.ring_all_gather.kernel_launches
        (logits * torch.from_numpy(c).to(device)).sum().backward()
        return (logits.detach().cpu(), k2,
                {k: p.grad.cpu() for k, p in model.named_parameters()})

    ring.ring_all_gather.kernel_launches = 0
    ring.ring_reduce_scatter.kernel_launches = 0
    card, k2, card_grads = run(cuda)
    assert (k2, ring.ring_all_gather.kernel_launches,
            ring.ring_reduce_scatter.kernel_launches) == (3, 3, 3)
    cpu, _, cpu_grads = run("cpu")
    scale = max(1.0, float(cpu.abs().max()))
    assert float((card - cpu).abs().max()) <= 1e-4 * scale
    # cuBLAS and the CPU's BLAS round products differently; ctx.attn.bias's
    # exact gradient is 0 (a softmax ignores a shared shift), hence the
    # floor.
    floor = 1e-3 * max(float(v.abs().max()) for v in cpu_grads.values())
    for k, v in cpu_grads.items():
        tol = 1e-4 * max(float(v.abs().max()), floor)
        assert float((card_grads[k] - v).abs().max()) <= tol, k


# -- the fixed-order segment sum (csrc/segment_sum.cu) ----------------------

def segment_case(device, dtype, cols, is_sorted, seed=5, rows=5000, n=700,
                 long=0):
    """Rows into n segments, leading, inner and trailing ones empty; with
    `long`, that many rows (a block-path segment) go to segment 5."""
    r = np.random.RandomState(seed)
    idx = r.randint(4, n - 50, 2 * rows)
    idx = idx[idx % 9 != 2][:rows]
    idx[r.permutation(rows)[:long]] = 5
    if is_sorted:
        idx = np.sort(idx)
    shape = (rows,) if cols is None else (rows, cols)
    vals = torch.from_numpy((r.randn(*shape) * 3).astype(np.float32)
                            ).to(dtype)
    return torch.from_numpy(idx).to(device), vals.to(device), n


@pytest.mark.parametrize("long", [0, 3000], ids=["short", "long"])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("is_sorted", [False, True])
@pytest.mark.parametrize("cols", [None, 1, 6, 8, 15, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_segment_sum_kernel_matches_plain_bit_for_bit(cuda, dtype, cols,
                                                      is_sorted, op, long):
    """Every dtype, 16-byte and element loads, sorted rows and rows read
    through the sort's permutation, with and without a segment long enough
    for the block path: the kernel's bits are the plain version's on the
    card and on the CPU."""
    idx, vals, n = segment_case(cuda, dtype, cols, is_sorted, long=long)
    segs = region.Segments(idx, n, is_sorted)
    before = region.segment_sum.kernel_launches
    got = region.segment_reduce_cuda(vals, segs, op)
    torch.cuda.synchronize()
    assert region.segment_sum.kernel_launches == before + 1
    assert torch.equal(got, region.segment_reduce_plain(vals, segs, op))
    cpu = region.segment_reduce_plain(
        vals.cpu(), region.Segments(idx.cpu(), n, is_sorted), op)
    assert torch.equal(got.cpu(), cpu)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, a NaN matching any NaN (its payload is the hardware's:
    the card and the CPU make different ones); +0 and -0 differ."""
    na, nb = a.isnan(), b.isnan()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    as_int = ints[a.element_size()]
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(as_int), b.masked_fill(nb, 0).view(as_int))


def identity_case(device, dtype, cols, is_sorted, op, seed=6):
    """Long segments where the kernel's tiles make them hard (one starting
    on a tile's first row, two sharing a tile, one over many tiles, one of
    exactly a tile) among short ones, their rows mostly the reduction's
    identity (+-0 for a sum, -inf for a maximum), with subnormals, +-inf
    and NaN in the rest."""
    r = np.random.RandomState(seed)
    elt = torch.empty((), dtype=dtype).element_size()
    tile = region.kernel_plan(1, cols or 1, 1, elt, True).tile
    lengths = [3, 0, 5, tile - 8, 2 * tile + 40, 7, tile + 3, 0, tile,
               9 * tile + 100, 4, 1]
    idx = np.repeat(np.arange(len(lengths)), lengths)
    n, rows = len(lengths) + 2, len(idx)
    if not is_sorted:
        idx = idx[r.permutation(rows)]
    shape = (rows,) if cols is None else (rows, cols)
    tiny = {torch.float32: 1e-45, torch.float64: 5e-324,
            torch.bfloat16: 9.2e-41, torch.float16: 6e-8}[dtype]
    pick = r.rand(*shape)
    v = np.where(r.rand(*shape) < 0.5, 0.0, -0.0)
    if op == "max":
        v = np.full(shape, -np.inf)
    live = (r.rand(rows) < 0.02)[(slice(None),) + (None,) * (len(shape) - 1)]
    v = np.where(live & (pick < 0.5), r.randn(*shape) * 3, v)
    v = np.where(live & (pick > 0.9), tiny * r.choice([-1, 1], shape), v)
    specials = r.choice([np.inf, -np.inf, np.nan], 12)
    flat = v.reshape(rows, -1)
    flat[r.randint(0, rows, 12), r.randint(0, flat.shape[1], 12)] = specials
    vals = torch.from_numpy(v).to(torch.float64).to(dtype)
    return torch.from_numpy(idx).to(device), vals.to(device), n


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("is_sorted", [False, True])
@pytest.mark.parametrize("cols", [None, 3, 8, 65, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_segment_sum_kernel_skips_identity_rows_bit_for_bit(
        cuda, dtype, cols, is_sorted, op):
    """The long blocks leave identity rows out of each chain: the bits are
    still the plain version's, on the card and on the CPU, and a second
    call (the hand-off counters back at 0) gives them again."""
    idx, vals, n = identity_case(cuda, dtype, cols, is_sorted, op)
    segs = region.Segments(idx, n, is_sorted)
    tile = region.kernel_plan(vals.shape[0], cols or 1, n,
                              vals.element_size(), True).tile
    assert bool(region.long_segments(segs.offsets, tile).any())
    got = region.segment_reduce_cuda(vals, segs, op)
    again = region.segment_reduce_cuda(vals, segs, op)
    torch.cuda.synchronize()
    want = region.segment_reduce_plain(vals, segs, op)
    assert same_bits(got, want) and same_bits(again, want)
    cpu = region.segment_reduce_plain(
        vals.cpu(), region.Segments(idx.cpu(), n, is_sorted), op)
    assert same_bits(got.cpu(), cpu)


def test_segment_sum_kernel_takes_unaligned_rows(cuda):
    idx, vals, n = segment_case(cuda, torch.float32, 8, False)
    shifted = torch.empty(vals.numel() + 1, device=cuda)[1:].view(vals.shape)
    shifted.copy_(vals)                       # 4 bytes off 16
    segs = region.Segments(idx, n)
    assert torch.equal(region.segment_reduce_cuda(shifted, segs, "sum"),
                       region.segment_reduce_plain(vals, segs, "sum"))


@pytest.mark.parametrize("op", ["sum", "max"])
def test_segment_sum_kernel_takes_a_strided_sorted_index(cuda, op):
    """A sorted index that is a column of an edge list (a strided view)
    reaches the long blocks as a dense int64 array: the plain version's
    bits.  A non-contiguous `ordered` put in by hand raises."""
    idx, vals, n = identity_case(cuda, torch.float32, 8, True, op)
    edges = torch.stack([torch.zeros_like(idx), idx], 1)
    segs = region.Segments(edges[:, 1], n, is_sorted=True)
    got = region.segment_reduce_cuda(vals, segs, op)
    cpu = region.segment_reduce_plain(
        vals.cpu(), region.Segments(idx.cpu(), n, is_sorted=True), op)
    assert same_bits(got.cpu(), cpu)
    segs.ordered = edges[:, 1]
    with pytest.raises(ValueError, match="contiguous int64"):
        region.segment_reduce_cuda(vals, segs, op)


def test_segment_sum_syncs_no_host(cuda):
    idx, vals, n = segment_case(cuda, torch.float32, 6, False)
    vals.requires_grad_(True)
    region.segment_sum(idx, vals, n)                  # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        region.segment_sum(idx, vals, n).sum().backward()
        region.segment_max(idx, vals, n).sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_segment_sum_gradients_match_the_cpu(cuda):
    grads = {}
    for device in (cuda, "cpu"):
        idx, vals, n = segment_case(device, torch.float32, 6, False)
        vals = vals.round().requires_grad_(True)       # ties for the max
        g = torch.from_numpy(np.random.RandomState(3).randn(n, 6).astype(
            np.float32)).to(device)
        ((region.segment_sum(idx, vals, n) * g).sum()
         + (region.segment_max(idx, vals, n).nan_to_num(0.0, 0.0, 0.0)
            * g).sum()).backward()
        grads[str(device)] = vals.grad.cpu()
    assert torch.equal(grads["cuda"], grads["cpu"])


def test_segment_sum_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    idx, vals, n = segment_case(cuda, torch.float32, 6, True)
    segs = region.Segments(idx, n, True)
    with pytest.raises(TypeError):
        region.segment_reduce_cuda(vals.int(), segs, "sum")
    with pytest.raises(ValueError, match="contiguous"):
        region.segment_reduce_cuda(vals.t().contiguous().t(), segs, "sum")
    with pytest.raises(ValueError, match="rows"):
        region.segment_reduce_cuda(vals[1:].contiguous(), segs, "sum")
    with pytest.raises(ValueError, match="CUDA"):
        region.segment_reduce_cuda(vals.cpu(), segs, "sum")
    with pytest.raises(ValueError, match="reduction"):
        region.segment_reduce_cuda(vals, segs, "mean")


def test_sharded_gradients_repeat_and_agree_across_halos(cuda):
    """Two steps of the sharded model per halo give the same bits, and the
    ring halo's logits and gradients equal the plain halo's."""
    r = np.random.RandomState(4)
    n, e = 400, 3000
    src = r.randint(0, n, e)
    dst = np.clip(src + r.randint(-30, 30, e), 0, n - 1)
    mask = (src != dst).astype(np.float32)
    g = gt.make_graph_batch(r.randn(1, n, 19), src[None], dst[None],
                            r.rand(1, e, 5), np.ones((1, n)), mask[None],
                            device=cuda)
    c = torch.from_numpy(r.randn(1, n, 3).astype(np.float32)).to(cuda)
    model = gt.ResGCNNet(hidden_channels=32, n_layers=2,
                         generator=torch.Generator().manual_seed(2)).to(cuda)
    runs = {}
    for halo in ("pallas_ring", "xla", "pallas_ring", "xla"):
        aggs = gt.mesh_aggregators(gt.make_graph_mesh(4, device=cuda), src,
                                   dst, mask, n, method="allgather",
                                   halo=halo)
        model.zero_grad(set_to_none=True)
        logits = model(g, aggregators=aggs)
        (logits * c).sum().backward()
        runs.setdefault(halo, []).append(
            [logits.detach()] + [p.grad.clone()
                                 for _, p in model.named_parameters()])
    for a, b in (runs["pallas_ring"], runs["xla"],
                 (runs["pallas_ring"][0], runs["xla"][0])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_mincut_kernel_refuses_another_halo(cuda, monkeypatch):
    """The kernel's sweep tiles report the halo they were compiled with,
    which is ops.maxflow.sweep_halo's at 4- and 8-connectivity; where the
    two differ the wrapper raises after the launch, which it counts."""
    for name in ("conn8", "conn4"):
        ex, r_fwd, _, conn, kw = mincut_case(name)
        e = ex.to(cuda)
        rf = tuple(r.to(cuda) for r in r_fwd)
        _, _, grid = maxflow.grid_mincut_cuda(
            e.clone(), tuple(r.clone() for r in rf),
            tuple(r.clone() for r in rf), conn)
        assert grid["halo"] == maxflow.sweep_halo(conn) == {8: 3, 4: 1}[conn]
    halo = maxflow.sweep_halo(conn)
    monkeypatch.setattr(maxflow, "sweep_halo", lambda c: halo - 1)
    before = maxflow.grid_mincut_cuda.kernel_launches
    with pytest.raises(RuntimeError, match="halo"):
        maxflow.grid_mincut_cuda(e, rf, rf, conn)
    assert maxflow.grid_mincut_cuda.kernel_launches == before + 1


def fragmented_labels(B: int, hw: int, grid: int, seed: int) -> np.ndarray:
    """SLIC-like labels whose cell borders wander pixel by pixel."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = []
    for _ in range(B):
        jy = np.clip(yy + r.randint(-3, 4, (hw, hw)), 0, hw - 1)
        jx = np.clip(xx + r.randint(-3, 4, (hw, hw)), 0, hw - 1)
        out.append((jy * grid // hw) * grid + jx * grid // hw)
    return np.stack(out).astype(np.int64)


# (labels, k, absorb_sweeps, max_sweeps): fragmented SLIC-like maps at two
# sizes, the spiral at the cap of both loops (caps 1, 2, 3 and 5 stop the
# kernel's super-blocks of 16 steps inside one), orphan absorption alone,
# and more orphan sweeps than the kernel runs in one pass.
def connectivity_cases():
    import chip_smoke as cs
    spiral = np.stack([cs.spiral_labels(96), cs.spiral_labels(96).T.copy()])
    return {
        "fragmented-96": (fragmented_labels(3, 96, 10, 0), 100, 4, 64),
        "fragmented-512": (fragmented_labels(2, 512, 22, 1), 484, 4, 64),
        "fragmented-odd": (fragmented_labels(2, 77, 7, 2)[:, :77, :61], 49,
                           4, 64),
        "spiral-cap-1": (spiral, 3, 0, 1),
        "spiral-cap-2": (spiral, 3, 0, 2),
        "spiral-cap-3": (spiral, 3, 0, 3),
        "spiral-cap-5": (spiral, 3, 0, 5),
        "absorb-only": (fragmented_labels(2, 128, 12, 3), 1, 2, 0),
        "absorb-9-sweeps": (fragmented_labels(2, 96, 10, 4), 100, 9, 64),
    }


@pytest.mark.parametrize("case", ["fragmented-96", "fragmented-512",
                                  "fragmented-odd", "spiral-cap-1",
                                  "spiral-cap-2", "spiral-cap-3",
                                  "spiral-cap-5", "absorb-only",
                                  "absorb-9-sweeps"])
def test_slic_connectivity_kernel_matches_plain(cuda, case):
    """csrc/slic_connectivity.cu against its plain versions on the card:
    the same labels, every image stopping on its own, caps included, and
    the plain version's component blocks and absorption rounds."""
    from gcn_grabcut_torch.ops import slic
    labels, k, absorb, sweeps = connectivity_cases()[case]
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(cuda)
    before = slic.repair_connectivity_cuda.kernel_launches
    got = slic.repair_connectivity_cuda(lab, k, absorb, sweeps)
    assert slic.repair_connectivity_cuda.kernel_launches == before + 1
    want = slic.absorb_orphans_plain(lab, absorb)
    if sweeps:
        want = slic.enforce_connectivity_plain(want, k, sweeps)
        assert (slic.kernel_loops(slic.repair_connectivity_cuda.last_ctrl)
                == slic.enforce_connectivity_plain.last_loops)
    assert torch.equal(got, want)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 5, 512])
def test_mask_components_kernel_matches_plain(cuda, connectivity, max_iters):
    """csrc/mask_components.cu against its plain version on the card: a
    serpentine (capped at 1, 2, 3 or 5 sweeps), random masks and ragged
    widths and heights (a row band and a column segment cut short), with
    the plain version's sweeps."""
    import chip_smoke as cs
    from gcn_grabcut_torch.ops import connected
    r = np.random.RandomState(connectivity + max_iters)
    masks = [cs.serpentine_mask(96)[None], r.rand(3, 96, 96) > 0.45,
             r.rand(2, 70, 131) > 0.3, np.ones((1, 33, 40), bool),
             np.zeros((1, 20, 20), bool), r.rand(2, 1543, 37) > 0.2]
    for m in masks:
        mask = torch.from_numpy(np.ascontiguousarray(m)).to(cuda)
        got = connected.connected_components_cuda(mask, connectivity,
                                                  max_iters)
        want = connected.connected_components_plain(mask, connectivity,
                                                    max_iters)
        assert torch.equal(got, want), m.shape
        assert (connected.kernel_tally(
            connected.connected_components_cuda.last_ctrl)["sweeps"]
            == connected.connected_components_plain.last_sweeps), m.shape


def test_build_kernels_sync_no_host(cuda):
    from gcn_grabcut_torch.ops import connected, slic
    lab = torch.from_numpy(fragmented_labels(2, 96, 10, 5)).to(cuda)
    mask = lab % 3 == 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slic.repair_connectivity_cuda(lab, 100, 4, 64)
        connected.connected_components_cuda(mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_graph_batch_on_the_card_equals_each_image_alone(cuda):
    """build_graph_batch_arrays, the trimap stage and the clean-up on the
    card: image b of a batch of three bit for bit as built alone."""
    from gcn_grabcut_torch import pipeline as tpipe
    r = np.random.RandomState(8)
    imgs = (r.rand(3, 128, 128, 3) * 255).astype(np.uint8)
    imgs[:, 40:90, 30:100] //= 3
    cfg = gt.SuperpixelGraphConfig(n_segments=120, bg_connectivity=True)
    batch = gt.build_graph_batch_arrays(imgs, cfg, device=cuda)
    k = batch["x"].shape[1]
    probs = torch.softmax(torch.from_numpy(
        r.randn(3, k, 3).astype(np.float32)).to(cuda), -1)
    grays = torch.from_numpy(imgs).to(cuda).float().mean(-1) / 255.0
    px = tpipe._project_probs_device(probs, batch["segments"], (128, 128))
    tri = tpipe._trimap_stage_device(px, batch["segments"], grays,
                                     batch["prior"], batch["node_mask"],
                                     0.6, 0.6, 4)
    masks = (tri == 1) | (tri == 3)
    post = tpipe._post_stage_device(masks.to(torch.uint8), tri,
                                    batch["segments"], 30.0, True, True,
                                    px[..., 1])
    for b in range(3):
        sl = slice(b, b + 1)
        one = gt.build_graph_batch_arrays(imgs[sl], cfg, device=cuda)
        for key, v in batch.items():
            assert torch.equal(v[b], one[key][0]), key
        t1 = tpipe._trimap_stage_device(px[sl], one["segments"], grays[sl],
                                        one["prior"], one["node_mask"], 0.6,
                                        0.6, 4)
        assert torch.equal(t1[0], tri[b])
        p1 = tpipe._post_stage_device(masks[sl].to(torch.uint8), tri[sl],
                                      one["segments"], 30.0, True, True,
                                      px[sl][..., 1])
        assert torch.equal(p1[0], post[b])
