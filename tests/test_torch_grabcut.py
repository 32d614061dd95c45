"""Port parity: GrabCut, min-cut, GMMs, connected components, the trimap
stage and the output packing of gcn_grabcut_torch against the JAX package.

The port's k-means++ seeding reproduces the JAX package's jax.random
noise (ops/threefry.py), tested here bit for bit; the GrabCut solves are
also compared from the same initial components (JAX's comp0).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gcn_grabcut_tpu import grabcut as jgc
from gcn_grabcut_tpu import pipeline as jpipe
from gcn_grabcut_tpu.ops import connected as jcc
from gcn_grabcut_tpu.ops import gmm as jgmm
from gcn_grabcut_tpu.ops import maxflow as jmf
from gcn_grabcut_torch import grabcut as tgc
from gcn_grabcut_torch import pipeline as tpipe
from gcn_grabcut_torch.ops import connected as tcc
from gcn_grabcut_torch.ops import gmm as tgmm
from gcn_grabcut_torch.ops import maxflow as tmf
from gcn_grabcut_torch.ops import threefry as ttf

torch.set_num_threads(1)


def cut_energy(excess, caps, offsets, fg):
    """Cost of the cut labelling `fg` (True = source side)."""
    H, W = excess.shape
    cost = np.maximum(-excess, 0)[fg].sum() + np.maximum(excess, 0)[~fg].sum()
    for c, (dy, dx) in zip(caps, offsets):
        ys, xs = np.mgrid[0:H, 0:W]
        qy, qx = ys + dy, xs + dx
        ok = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
        cross = ok.copy()
        cross[ok] = fg[ys[ok], xs[ok]] != fg[qy[ok], qx[ok]]
        cost += c[cross].sum()
    return float(cost)


def lattice(seed, H=14, W=17, n_dirs=4, integer=False):
    r = np.random.RandomState(seed)
    if integer:
        excess = r.randint(-6, 7, (H, W)).astype(np.float32)
        caps = tuple(r.randint(0, 4, (H, W)).astype(np.float32)
                     for _ in range(n_dirs))
    else:
        excess = (r.randn(H, W) * 3).astype(np.float32)
        caps = tuple(r.rand(H, W).astype(np.float32) for _ in range(n_dirs))
    return excess, caps


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mincut_energy_matches_jax(seed, connectivity):
    offsets = tmf.OFFSETS_8 if connectivity == 8 else tmf.OFFSETS_4
    excess, caps = lattice(seed, n_dirs=len(offsets))
    jfg = np.asarray(jmf.grid_mincut(jnp.asarray(excess),
                                     tuple(map(jnp.asarray, caps)),
                                     connectivity=connectivity))
    tfg = tmf.grid_mincut(torch.from_numpy(excess),
                          tuple(map(torch.from_numpy, caps)),
                          connectivity=connectivity).numpy()
    je = cut_energy(excess, caps, offsets, jfg)
    te = cut_energy(excess, caps, offsets, tfg)
    assert abs(te - je) <= 1e-4 * max(1.0, abs(je))


@pytest.mark.parametrize("seed", [3, 4])
def test_mincut_masks_equal_on_integer_capacities(seed):
    excess, caps = lattice(seed, n_dirs=4, integer=True)
    jfg = np.asarray(jmf.grid_mincut(jnp.asarray(excess),
                                     tuple(map(jnp.asarray, caps))))
    tfg = tmf.grid_mincut(torch.from_numpy(excess),
                          tuple(map(torch.from_numpy, caps))).numpy()
    np.testing.assert_array_equal(tfg, jfg)


def test_stateful_mincut_matches_jax_flow_state():
    excess, caps = lattice(5, n_dirs=4, integer=True)
    jr = jmf._fresh_residuals(tuple(map(jnp.asarray, caps)), jmf.OFFSETS_8)
    tr = tmf._fresh_residuals(tuple(map(torch.from_numpy, caps)),
                              tmf.OFFSETS_8)
    jout = jmf.grid_mincut_stateful(jnp.asarray(excess), *jr)
    tout = tmf.grid_mincut_stateful(torch.from_numpy(excess), *tr)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=1e-5)


def blob_scene(H=48, W=56, seed=0):
    """An image and a trimap with definite and probable bands."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    d2 = (yy - H / 2) ** 2 + (xx - W / 2) ** 2
    img = (r.rand(H, W, 3) * 60 + 20).astype(np.float32)
    inside = d2 < (H / 3) ** 2
    img[inside] = (r.rand(int(inside.sum()), 3) * 60 + 170)
    tri = np.full((H, W), 0, np.uint8)
    tri[d2 < (H / 2.2) ** 2] = 2
    tri[d2 < (H / 2.8) ** 2] = 3
    tri[d2 < (H / 5) ** 2] = 1
    return img, tri


def jax_comp0(img, tri):
    fg = jnp.asarray((tri == 1) | (tri == 3))
    pix = jnp.asarray(img)
    fc = jgmm.kmeans(pix, fg.astype(jnp.float32), 5, seed=0)
    bc = jgmm.kmeans(pix, 1.0 - fg.astype(jnp.float32), 5, seed=1)
    return np.array(jnp.where(fg, fc, bc))


def test_grabcut_solve_agrees_given_comp0():
    img, tri = blob_scene()
    comp0 = jax_comp0(img, tri)
    jm, jcomp = jgc._grabcut_solve(jnp.asarray(img), jnp.asarray(tri),
                                   jnp.asarray(comp0), 50.0, 5, 5)
    tm, tcomp = tgc._grabcut_solve(torch.from_numpy(img),
                                   torch.from_numpy(tri),
                                   torch.from_numpy(comp0).long(), 50.0, 5, 5)
    agree = float((tm.numpy() == np.asarray(jm)).mean())
    print(f"GrabCut mask agreement with JAX: {agree:.6f}")
    assert agree >= 0.999
    assert float((tcomp.numpy() == np.asarray(jcomp)).mean()) >= 0.999


def test_grabcut_batch_device_matches_given_comp0():
    img, tri = blob_scene(seed=1)
    comp0 = jax_comp0(img, tri)
    jmask, _ = jgc._grabcut_solve(jnp.asarray(img), jnp.asarray(tri),
                                  jnp.asarray(comp0), 50.0, 5, 5)
    jbin = np.isin(np.asarray(jmask), (1, 3)).astype(np.uint8)
    tbin = tgc.grabcut_batch_device(
        torch.from_numpy(img)[None], torch.from_numpy(tri)[None],
        comp0=torch.from_numpy(comp0)[None])[0].numpy()
    assert float((tbin == jbin).mean()) >= 0.999


def test_grabcut_degenerate_trimap_keeps_own_labels():
    img, _ = blob_scene()
    tri = np.full(img.shape[:2], 3, np.uint8)
    jout = np.asarray(jgc.grabcut_batch_device(jnp.asarray(img)[None],
                                               jnp.asarray(tri)[None]))
    tout = tgc.grabcut_batch_device(torch.from_numpy(img)[None],
                                    torch.from_numpy(tri)[None]).numpy()
    np.testing.assert_array_equal(tout, jout)


def test_gmm_fit_and_scores_match():
    img, tri = blob_scene()
    comp0 = jax_comp0(img, tri)
    sel = ((tri == 1) | (tri == 3)).astype(np.float32)
    jg = jgmm.fit_gmm(jnp.asarray(img), jnp.asarray(sel), jnp.asarray(comp0),
                      5)
    tg = tgmm.fit_gmm(torch.from_numpy(img), torch.from_numpy(sel),
                      torch.from_numpy(comp0).long(), 5)
    for key in ("weights", "means", "counts"):
        np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tgmm.gmm_log_prob(torch.from_numpy(img), tg).numpy(),
        np.asarray(jgmm.gmm_log_prob(jnp.asarray(img), jg)),
        rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(
        tgmm.assign_components(torch.from_numpy(img), tg).numpy(),
        np.asarray(jgmm.assign_components(jnp.asarray(img), jg)))


def test_kmeans_is_seeded_and_valid():
    img, tri = blob_scene()
    w = torch.from_numpy(((tri == 1) | (tri == 3)).astype(np.float32))

    def run(seed):
        return tgmm.kmeans(torch.from_numpy(img), w, 5, seed=seed)

    a, b = run(0), run(0)
    assert torch.equal(a, b)
    assert a.shape == tri.shape and int(a.min()) >= 0 and int(a.max()) < 5


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_threefry_reproduces_jax_random(seed):
    import jax
    key = jax.random.PRNGKey(seed)
    tkey = (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))
    assert np.array_equal(np.asarray(key), np.array(tkey))
    tiny = np.finfo(np.float32).tiny
    for n in (1, 7, 3000):
        key, sub = jax.random.split(key)
        tkey, tsub = ttf.split(tkey)
        assert np.array_equal(np.asarray(sub), np.array(tsub))
        assert np.array_equal(np.asarray(key), np.array(tkey))
        np.testing.assert_array_equal(
            ttf.uniform(tsub, n, minval=tiny),
            np.asarray(jax.random.uniform(sub, (n,), minval=tiny)))
        np.testing.assert_allclose(ttf.gumbel(tsub, n),
                                   np.asarray(jax.random.gumbel(sub, (n,))),
                                   rtol=1e-6, atol=1e-6)


def test_kmeans_matches_jax():
    """Same noise, same centres: the labels equal JAX's."""
    for seed_img in (0, 1):
        img, tri = blob_scene(seed=seed_img)
        fg = ((tri == 1) | (tri == 3)).astype(np.float32)
        for w, seed in ((fg, 0), (1.0 - fg, 1)):
            want = np.asarray(jgmm.kmeans(jnp.asarray(img), jnp.asarray(w),
                                          5, seed=seed))
            got = tgmm.kmeans(torch.from_numpy(img), torch.from_numpy(w), 5,
                              seed=seed).numpy()
            np.testing.assert_array_equal(got, want)


def random_masks():
    r = np.random.RandomState(0)
    masks = [r.rand(40, 50) > 0.55, r.rand(40, 50) > 0.3,
             np.zeros((20, 30), bool)]
    ring = np.zeros((40, 40), bool)
    ring[5:35, 5:35] = True
    ring[9:31, 9:31] = False
    ring[15:25, 15:25] = True          # an island inside the ring
    spiral = np.zeros((30, 30), bool)
    spiral[2, 2:28] = spiral[2:28, 27] = spiral[27, 4:28] = True
    spiral[6:28, 4] = spiral[6, 4:24] = spiral[6:24, 23] = True
    return masks + [ring, spiral]


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_exact(i, connectivity):
    m = random_masks()[i]
    j = np.asarray(jcc.connected_components(jnp.asarray(m),
                                            connectivity=connectivity))
    t = tcc.connected_components(torch.from_numpy(m)[None],
                                 connectivity=connectivity)[0].numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", ["min_area", "keep_largest", "posterior"])
@pytest.mark.parametrize("i", range(4))
def test_clean_mask_exact(i, mode):
    m = random_masks()[i].astype(np.uint8)
    min_area = 0.002 * m.size * 5
    keep_largest = mode != "min_area"
    post = None
    if mode == "posterior":
        post = np.random.RandomState(i).rand(*m.shape).astype(np.float32)
    j = np.asarray(jcc._clean_mask_jit(
        jnp.asarray(m), jnp.float32(min_area), keep_largest,
        None if post is None else jnp.asarray(post)))
    t = tcc._clean_mask(torch.from_numpy(m)[None], min_area, keep_largest,
                        None if post is None else torch.from_numpy(post)[None])
    np.testing.assert_array_equal(t[0].numpy(), j)


@pytest.mark.parametrize("want_segments", [True, False])
def test_post_stage_packing_exact(want_segments):
    r = np.random.RandomState(2)
    B, H, W = 2, 21, 27       # H*W not a multiple of 8: ragged planes
    masks = (r.rand(B, H, W) > 0.4).astype(np.uint8)
    trimaps = r.randint(0, 4, (B, H, W)).astype(np.uint8)
    segments = r.randint(0, 3000, (B, H, W)).astype(np.int32)
    min_area = 0.002 * H * W
    j = np.asarray(jpipe._post_stage_device(
        jnp.asarray(masks), jnp.asarray(trimaps), jnp.asarray(segments),
        jnp.float32(min_area), False, want_segments))
    t = tpipe._post_stage_device(
        torch.from_numpy(masks), torch.from_numpy(trimaps),
        torch.from_numpy(segments), min_area, False, want_segments).numpy()
    np.testing.assert_array_equal(t, j)
    tm, tt, ts = tpipe._unpack_post_host(t, H, W, want_segments)
    jm, jt, js = jpipe._unpack_post_host(j, H, W, want_segments)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tt, trimaps)
    if want_segments:
        np.testing.assert_array_equal(ts, segments)
    else:
        assert ts is None and js is None


@pytest.mark.parametrize("seeded", [False, True])
def test_trimap_stage_matches_jax(seeded):
    """Equal except at pixels whose filtered posterior lies within 1e-5 of
    a threshold.  `seeded` makes every region P(FG)-leaning, so the
    prior seeding of the missing background side runs."""
    r = np.random.RandomState(7)
    B, H, W, K = 1, 40, 48, 60
    segments = np.repeat(np.repeat(np.arange(K).reshape(6, 10), 7, 0), 5,
                         1)[:H, :W][None].astype(np.int32)
    logits = r.randn(B, K, 3).astype(np.float32)
    if seeded:
        logits[..., 2] += 4.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    grays = r.rand(B, H, W).astype(np.float32)
    priors = r.rand(B, K, 3).astype(np.float32)
    nm = np.ones((B, K), np.float32)
    nm[0, :5] = 0.0
    j = np.asarray(jpipe._trimap_stage_device(
        jnp.asarray(probs), jnp.asarray(segments), jnp.asarray(grays),
        jnp.asarray(priors), jnp.asarray(nm), jnp.float32(0.55),
        jnp.float32(0.55), 4))
    px = tpipe._project_probs_device(torch.from_numpy(probs),
                                     torch.from_numpy(segments), (H, W))
    t = tpipe._trimap_stage_device(
        px, torch.from_numpy(segments),
        torch.from_numpy(grays), torch.from_numpy(priors),
        torch.from_numpy(nm), 0.55, 0.55, 4).numpy()
    # Pixels near a threshold may flip under another summation order.
    from gcn_grabcut_tpu.ops import image as jim
    near = np.zeros_like(t, bool)
    for c in (0, 2):
        px = probs[0][:, c][segments[0]]
        filt = np.clip(np.asarray(jim.guided_filter(
            jnp.asarray(grays[0]), jnp.asarray(px), 4, 1e-3)), 0, 1)
        near[0] |= np.abs(filt - np.float32(0.55)) < 1e-5
    assert (t != j)[~near].sum() == 0
    if seeded:
        assert (t == 2).any()       # the background side was seeded


def test_multiscale_trimap_stage_matches_jax():
    """Scale-averaged pixel posteriors (two scales) through the trimap
    stage, against `_trimap_stage_ms_device`; prior seeds from the
    full-resolution graph."""
    r = np.random.RandomState(8)
    B, H, W, K = 2, 40, 48, 60
    segments = np.repeat(np.repeat(np.arange(K).reshape(6, 10), 7, 0), 5,
                         1)[:H, :W][None].repeat(B, 0).astype(np.int32)
    logits = 3.0 * r.randn(2, B, K, 3)
    node = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))[..., ::2]
    px_stack = np.stack([np.stack([node[s, b][segments[b]] for b in range(B)])
                         for s in range(2)]).astype(np.float32)
    grays = r.rand(B, H, W).astype(np.float32)
    priors = r.rand(B, K, 3).astype(np.float32)
    nm = np.ones((B, K), np.float32)
    nm[:, :5] = 0.0
    j = np.asarray(jpipe._trimap_stage_ms_device(
        jnp.asarray(px_stack), jnp.asarray(grays), jnp.asarray(priors),
        jnp.asarray(nm), jnp.asarray(segments), jnp.float32(0.65),
        jnp.float32(0.65), 4))
    t = tpipe._trimap_stage_device(
        torch.from_numpy(px_stack).mean(dim=0), torch.from_numpy(segments),
        torch.from_numpy(grays), torch.from_numpy(priors),
        torch.from_numpy(nm), 0.65, 0.65, 4).numpy()
    from gcn_grabcut_tpu.ops import image as jim
    near = np.zeros_like(t, bool)
    mean = px_stack.mean(0)
    for b in range(B):
        filt = [np.clip(np.asarray(jim.guided_filter(
            jnp.asarray(grays[b]), jnp.asarray(mean[b, ..., c]), 4, 1e-3)),
            0, 1) for c in (0, 1)]
        near[b] = ((np.abs(filt[0] - np.float32(0.65)) < 1e-5)
                   | (np.abs(filt[1] - np.float32(0.65)) < 1e-5)
                   | (np.abs(filt[0] - filt[1]) < 1e-5))
    assert (t != j)[~near].sum() == 0
    assert len(np.unique(t)) >= 3
