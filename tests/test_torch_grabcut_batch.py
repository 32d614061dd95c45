"""The lock-step batched GrabCut of gcn_grabcut_torch: the batched min-cut
(``ops.maxflow.grid_mincut_batch``), the batched GMM steps and
``grabcut._grabcut_solve_batch`` bit for bit against their per-image
calls; ``_grabcut_solve_batch`` against the JAX package's vmapped solve;
a one-sided trimap inside a batch; and ``segment_batch``'s pixel budget.

Images are RGB with integer values (as the pipeline gives them) and at
most 72 px: the port's device solver is slow on the CPU.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gcn_grabcut_tpu import grabcut as jgc
from gcn_grabcut_tpu.ops import gmm as jgmm
import gcn_grabcut_torch as gt
from gcn_grabcut_torch import grabcut as tgc
from gcn_grabcut_torch.ops import gmm as tgmm
from gcn_grabcut_torch.ops import maxflow as tmf

torch.set_num_threads(1)

H, W = 64, 72
GAMMA, N_ITER, K = 50.0, 5, 5
MIN_JAX_AGREEMENT = 0.999   # per image (test_torch_grabcut.py's bar)


def scene(seed: int):
    """A noise-textured object on a noise-textured ground, with definite
    and probable bands whose widths differ by seed, so the images'
    min-cuts converge after different numbers of rounds."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = ((yy - H / 2 - 2 * seed) / (H / 3)) ** 2 \
        + ((xx - W / 2 + 3 * seed) / (W / 3)) ** 2
    img = (r.rand(H, W, 3) * 70 + 20 + 25 * seed).astype(np.uint8)
    inside = d2 < 1
    img[inside] = (140 + r.rand(int(inside.sum()), 3) * 100).astype(np.uint8)
    tri = np.zeros((H, W), np.uint8)
    tri[d2 < 1.9 + 0.3 * seed] = 2
    tri[d2 < 1.1] = 3
    tri[d2 < 0.2 - 0.05 * seed] = 1
    return img.astype(np.float32), tri


def batch(seeds=(0, 1, 2)):
    imgs, tris = zip(*map(scene, seeds))
    return np.stack(imgs), np.stack(tris)


def jax_comp0(imgs, tris):
    """JAX's k-means seeding of each image (seeds 0 / 1 per class)."""
    out = []
    for img, tri in zip(imgs, tris):
        fg = jnp.asarray((tri == 1) | (tri == 3))
        fc = jgmm.kmeans(jnp.asarray(img), fg.astype(jnp.float32), K, seed=0)
        bc = jgmm.kmeans(jnp.asarray(img), 1.0 - fg.astype(jnp.float32), K,
                         seed=1)
        out.append(np.asarray(jnp.where(fg, fc, bc)))
    return np.stack(out)


# ------------------------------------------------------------- the min-cut


def mincut_problems(seed=0, h=40, w=44):
    """Three lattices: one with no excess (converged before its first
    round), a short one, and a long one (a source strip and a sink strip
    at opposite edges over weak capacities)."""
    r = np.random.RandomState(seed)
    ex = np.stack([-np.abs(r.randn(h, w)) - 0.1, r.randn(h, w) * 2,
                   np.zeros((h, w))]).astype(np.float32)
    ex[2, :, :4] = 40.0
    ex[2, :, -4:] = -40.0
    caps = np.stack([r.rand(3, h, w) for _ in tmf.OFFSETS_8]
                    ).astype(np.float32)
    caps[:, 2] *= 0.5
    r_fwd = tuple(tmf._zero_border(torch.from_numpy(c), dy, dx)
                  for c, (dy, dx) in zip(caps, tmf.OFFSETS_8))
    return torch.from_numpy(ex), r_fwd


def assert_solves_equal(batched, singles):
    fg, e, r_fwd, r_bwd = batched
    for b, (fg1, e1, rf1, rb1) in enumerate(singles):
        assert torch.equal(fg[b], fg1), b
        assert torch.equal(e[b], e1), b
        for d in range(len(rf1)):
            assert torch.equal(r_fwd[d][b], rf1[d]), (b, d)
            assert torch.equal(r_bwd[d][b], rb1[d]), (b, d)


@pytest.mark.parametrize("carried", [False, True])
def test_batched_mincut_matches_per_image(carried):
    """Each image of a lock-step solve ends bit for bit where its own
    solve ends -- fg, excess and both residual planes -- fresh and from
    carried residuals, while the images converge after 0, a few and many
    rounds; the batch pays one sync per round and relabel block."""
    kw = dict(sweeps_per_round=8, unroll=2)
    ex, r_fwd = mincut_problems()
    r_bwd = r_fwd
    if carried:
        first = tmf.grid_mincut_batch(ex, r_fwd, r_bwd, **kw)
        delta = np.random.RandomState(1).randn(*ex.shape).astype(np.float32)
        ex = first[1] + torch.from_numpy(delta) * torch.tensor(
            [0.0, 1.0, 1.0])[:, None, None]
        r_fwd, r_bwd = first[2], first[3]
    tmf.counts.reset()
    singles = [tmf.grid_mincut_stateful(ex[b], tuple(r[b] for r in r_fwd),
                                        tuple(r[b] for r in r_bwd), **kw)
               for b in range(3)]
    loop_syncs = tmf.counts.syncs
    loop_rounds = np.concatenate(tmf.counts.rounds)
    tmf.counts.reset()
    batched = tmf.grid_mincut_batch(ex, r_fwd, r_bwd, **kw)
    rounds = tmf.counts.rounds[0]
    print(f"rounds per image {rounds.tolist()}; syncs lock step "
          f"{tmf.counts.syncs}, image by image {loop_syncs}")
    assert_solves_equal(batched, singles)
    np.testing.assert_array_equal(rounds, loop_rounds)
    assert rounds[0] == 0 and len(set(rounds.tolist())) == 3
    np.testing.assert_array_equal(tmf.counts.sweeps[0], rounds * 8)
    assert tmf.counts.syncs < loop_syncs


def test_single_image_mincut_is_the_batch_of_one():
    ex, r_fwd = mincut_problems(seed=3)
    caps = tuple(r[1] for r in r_fwd)
    fg = tmf.grid_mincut(ex[1], caps)
    out = tmf.grid_mincut_batch(ex[1:2], tuple(r[1:2] for r in r_fwd),
                                tuple(r[1:2] for r in r_fwd))
    assert torch.equal(fg, out[0][0])


# ------------------------------------------------------------ the GMM steps


@pytest.mark.parametrize("color_space", ["rgb", "lab"])
def test_batched_gmm_steps_match_per_image(color_space):
    """kmeans, fit_gmm, component_scores, assign_components, gmm_log_prob
    and the pairwise capacities on (B, H, W, 3) equal their per-image
    calls bit for bit."""
    imgs, tris = batch()
    pix = tgc.preprocess_device(torch.from_numpy(imgs), color_space)
    fg = torch.from_numpy((tris == 1) | (tris == 3))
    for w, seed in ((fg.float(), 0), ((~fg).float(), 1)):
        lab = tgmm.kmeans(pix, w, K, seed=seed)
        for b in range(len(imgs)):
            assert torch.equal(lab[b], tgmm.kmeans(pix[b], w[b], K,
                                                   seed=seed)), (seed, b)
    comp = tgmm.kmeans(pix, fg.float(), K, seed=0)
    gmm = tgmm.fit_gmm(pix, fg.float(), comp, K)
    scores = tgmm.component_scores(pix, gmm)
    assign = tgmm.assign_components(pix, gmm)
    logp = tgmm.gmm_log_prob(pix, gmm)
    caps, beta = tgc._pairwise_caps(pix, GAMMA)
    for b in range(len(imgs)):
        one = tgmm.fit_gmm(pix[b], fg[b].float(), comp[b], K)
        for name, a in one.items():
            assert torch.equal(gmm[name][b], a), (name, b)
        assert torch.equal(scores[b], tgmm.component_scores(pix[b], one))
        assert torch.equal(assign[b], tgmm.assign_components(pix[b], one))
        assert torch.equal(logp[b], tgmm.gmm_log_prob(pix[b], one))
        caps1, beta1 = tgc._pairwise_caps(pix[b], GAMMA)
        assert torch.equal(beta[b], beta1)
        for c, c1 in zip(caps, caps1):
            assert torch.equal(c[b], c1)


def test_batched_kmeans_matches_jax_per_image():
    """The same noise for every image of a batch (JAX vmaps kmeans with
    one seed): the batched labels equal JAX's per image."""
    imgs, tris = batch()
    fg = (tris == 1) | (tris == 3)
    got = tgmm.kmeans(torch.from_numpy(imgs),
                      torch.from_numpy(fg.astype(np.float32)), K,
                      seed=0).numpy()
    for b in range(len(imgs)):
        want = np.asarray(jgmm.kmeans(jnp.asarray(imgs[b]),
                                      jnp.asarray(fg[b], jnp.float32), K,
                                      seed=0))
        np.testing.assert_array_equal(got[b], want)


# ------------------------------------------------------------ the solve


@pytest.fixture(scope="module")
def solves():
    imgs, tris = batch()
    comp0 = jax_comp0(imgs, tris)
    pix, t = torch.from_numpy(imgs), torch.from_numpy(tris)
    c0 = torch.from_numpy(comp0).long()
    tmf.counts.reset()
    masks, comps = tgc._grabcut_solve_batch(pix, t, c0, GAMMA, N_ITER, K)
    lock_syncs = tmf.counts.syncs
    tmf.counts.reset()
    loop = [tgc._grabcut_solve(pix[b], t[b], c0[b], GAMMA, N_ITER, K)
            for b in range(len(imgs))]
    return dict(imgs=imgs, tris=tris, comp0=comp0, masks=masks, comps=comps,
                loop=loop, lock_syncs=lock_syncs,
                loop_syncs=tmf.counts.syncs)


def test_grabcut_solve_batch_matches_loop(solves):
    """The lock-step solve equals `_grabcut_solve` image by image: masks
    and components bit for bit, with fewer host syncs."""
    for b, (m, c) in enumerate(solves["loop"]):
        assert torch.equal(solves["masks"][b], m), b
        assert torch.equal(solves["comps"][b], c), b
        assert 0 < float((m == 3).float().mean()) < 1
    print(f"syncs: lock step {solves['lock_syncs']}, image by image "
          f"{solves['loop_syncs']}")
    assert solves["lock_syncs"] < solves["loop_syncs"]


def test_grabcut_solve_batch_matches_jax(solves):
    """Against the JAX package's `_grabcut_solve_batch` (its vmap of the
    solve) from JAX's k-means components."""
    jm, jc = jgc._grabcut_solve_batch(
        jnp.asarray(solves["imgs"]), jnp.asarray(solves["tris"]),
        jnp.asarray(solves["comp0"]), GAMMA, N_ITER, K)
    jm, jc = np.asarray(jm), np.asarray(jc)
    for b in range(len(jm)):
        agree = float((solves["masks"][b].numpy() == jm[b]).mean())
        comp_agree = float((solves["comps"][b].numpy() == jc[b]).mean())
        print(f"image {b}: mask agreement with JAX {agree:.6f}, components "
              f"{comp_agree:.6f}")
        assert agree >= MIN_JAX_AGREEMENT
        assert comp_agree >= MIN_JAX_AGREEMENT


@pytest.mark.parametrize("one_sided", [3, 0])
def test_one_sided_trimap_inside_a_batch(one_sided):
    """A trimap that stays one-sided (all probable FG, or all BG) in the
    middle of a batch keeps its own labelling, equal to JAX's
    grabcut_batch_device; the other images equal their solo solves and
    the plain image-by-image version."""
    imgs, tris = batch()
    tris[1] = one_sided
    rgb, t = torch.from_numpy(imgs), torch.from_numpy(tris)
    out = tgc.grabcut_batch_device(rgb, t)
    want = np.asarray(jgc.grabcut_batch_device(jnp.asarray(imgs[1:2]),
                                               jnp.asarray(tris[1:2])))[0]
    np.testing.assert_array_equal(out[1].numpy(), want)
    assert torch.equal(out, tgc.grabcut_batch_loop(rgb, t))
    for b in (0, 2):
        assert torch.equal(out[b], tgc.grabcut_batch_device(
            rgb[b:b + 1], t[b:b + 1])[0]), b


def test_repair_is_branchless_per_image():
    """Each trimap of a batch is repaired on its own: all probable FG and
    all probable BG stay one-sided; a trimap with BG but no FG has its
    probable FG promoted and keeps its probable BG."""
    tris = np.full((3, 4, 5), 3, np.uint8)
    tris[1] = 2
    tris[2, :, :2] = 0
    tris[2, 0, 0] = 2
    t, degenerate = tgc._repair(torch.from_numpy(tris))
    assert degenerate.tolist() == [True, True, False]
    assert (t[0] == 1).all() and (t[1] == 0).all()
    assert set(t[2].unique().tolist()) == {0, 1, 2}


# ------------------------------------------------------ the pixel budget


@pytest.fixture(scope="module")
def pipe():
    return gt.GCNGrabCutPipeline(gt.ResGCNNet(hidden_channels=16, n_layers=2),
                                 gt.SuperpixelGraphConfig(n_segments=60),
                                 device="cpu")


def test_segment_batch_follows_the_pixel_budget(pipe, monkeypatch):
    """Up to BATCH_SOLVE_PIXEL_BUDGET pixels segment_batch solves in lock
    step; above it image by image through the GrabCut class (the JAX
    package's rule), with the same masks."""
    imgs = [scene(s)[0].astype(np.uint8) for s in range(3)]
    calls = {"lock": 0, "class": 0}
    lock, run = tgc.grabcut_batch_device, tgc.GrabCut.run_with_trimap

    def counting_lock(*a, **kw):
        calls["lock"] += 1
        return lock(*a, **kw)

    def counting_run(self, trimap):
        calls["class"] += 1
        return run(self, trimap)

    from gcn_grabcut_torch import pipeline as tpipe
    monkeypatch.setattr(tpipe, "grabcut_batch_device", counting_lock)
    monkeypatch.setattr(tgc.GrabCut, "run_with_trimap", counting_run)
    monkeypatch.setattr(tgc, "BATCH_SOLVE_PIXEL_BUDGET", 3 * H * W)
    ref = pipe.segment_batch(imgs)
    assert calls == {"lock": 1, "class": 0}
    monkeypatch.setattr(tgc, "BATCH_SOLVE_PIXEL_BUDGET", 3 * H * W - 1)
    res = pipe.segment_batch(imgs)
    assert calls == {"lock": 1, "class": 3}
    for r, w in zip(res, ref):
        assert 0 < w.binary_mask.mean() < 1
        np.testing.assert_array_equal(r.binary_mask, w.binary_mask)
