"""Port parity: the modules of the dense 500-superpixel path against the
JAX package on seeded numpy inputs -- the dense adjacency, the dense
ResGCNNet forward, the 3-member ensemble read from the repo's bgc
checkpoints, the dense k-NN, the dense and geodesic priors, and the
bilinear resize of the multi-scale path.  Shapes: K = 484 (a 128 px
image with n_segments=500, as at 512 px), D=16 n=2 for the seeded model.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu import build_model as jbuild_model, init_model
from gcn_grabcut_tpu import graph_build as jgb
from gcn_grabcut_tpu.core.graph import make_graph_batch as jmake_graph_batch
from gcn_grabcut_tpu.models import layers as jlayers
from gcn_grabcut_tpu.models.factory import apply_model as japply_model
from gcn_grabcut_tpu.ops import edges as jedges
from gcn_grabcut_tpu.ops import image as jim
from gcn_grabcut_tpu.ops import prior as jprior
from gcn_grabcut_tpu.ops import region as jregion
from gcn_grabcut_tpu.ops import slic as jslic
from gcn_grabcut_tpu.train.checkpoints import load_model_auto as jload
import gcn_grabcut_torch as gt
from gcn_grabcut_torch.models import convert
from gcn_grabcut_torch.models import layers as tlayers
from gcn_grabcut_torch.ops import edges as tedges
from gcn_grabcut_torch.ops import image as tim
from gcn_grabcut_torch.ops import prior as tprior

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENSEMBLE = ",".join(str(ROOT / f"examples/ensemble_r5/bgc_s4{i}.msgpack")
                    for i in (2, 3, 4))
HW = 128
N_SEGMENTS = 500
K = 484
LOGITS_TOL = 1e-4      # fp32 both sides, summation orders differ
ENSEMBLE_PROBS_TOL = 1e-5
PRIOR_TOL = 1e-5
RESIZE_TOL = 1e-4


def image(seed=0, hw=HW):
    """Smooth background, a brighter disc, and a frame touching the border
    (so the geodesic prior has both reachable and cut-off regions)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    img = np.stack([60 + 40 * yy, 80 + 30 * xx, 70 + 20 * yy * xx], -1)
    img = img + r.randn(hw, hw, 3) * 6
    disc = (yy - 0.5) ** 2 + (xx - 0.45) ** 2 < 0.09
    img[disc] = [200, 90, 60] + r.randn(disc.sum(), 3) * 10
    img[:, :6] = [20, 20, 20]
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX graph build's intermediates on one image."""
    rgb = jnp.asarray(image(), jnp.float32)
    lab = jim.rgb_to_lab(rgb)
    segments = jslic.slic(lab, n_segments=N_SEGMENTS)
    st = jregion.region_statistics(segments, lab, jim.rgb_to_hsv(rgb),
                                   jim.gradient_magnitude(
                                       jim.rgb_to_gray(rgb)), K)
    adj_pairs, _, adj_mask = jedges.adjacency_pairs(segments, K)
    return segments, lab, st, adj_pairs, adj_mask


def t(a):
    return torch.from_numpy(np.array(a))


def test_dense_adjacency_accumulates_duplicates():
    r = np.random.RandomState(0)
    G, N, E = 2, 30, 200
    src = r.randint(0, N, (G, E))
    dst = r.randint(0, N, (G, E))
    src[:, :20] = src[:, 20:40]          # duplicated edges
    dst[:, :20] = dst[:, 20:40]
    mask = (r.rand(G, E) > 0.2).astype(np.float32)
    src[mask == 0] = 0                   # padded slots point at node 0
    dst[mask == 0] = 0
    j = np.asarray(jlayers.dense_adjacency(jnp.asarray(src),
                                           jnp.asarray(dst),
                                           jnp.asarray(mask), N))
    a = tlayers.dense_adjacency(t(src), t(dst), t(mask), N)
    assert j.max() >= 2.0
    np.testing.assert_array_equal(a.numpy(), j)
    np.testing.assert_allclose(
        tlayers.gcn_norm_adjacency(a).numpy(),
        np.asarray(jlayers.gcn_norm_adjacency(jnp.asarray(j))), rtol=1e-6)
    np.testing.assert_allclose(
        tlayers.mean_adjacency(a).numpy(),
        np.asarray(jlayers.mean_adjacency(jnp.asarray(j))), rtol=1e-6)


def _random_batch(seed=0, G=2, N=60, E=300):
    r = np.random.RandomState(seed)
    x = r.randn(G, N, 19).astype(np.float32)
    src = r.randint(0, N - 5, (G, E))
    dst = r.randint(0, N - 5, (G, E))
    emask = (src != dst).astype(np.float32)
    emask[:, -20:] = 0.0
    src[emask == 0] = 0
    dst[emask == 0] = 0
    attr = r.rand(G, E, 5).astype(np.float32)
    nmask = np.ones((G, N), np.float32)
    nmask[:, -5:] = 0.0
    return x, src, dst, attr, nmask, emask


def test_dense_forward_matches_jax():
    arrays = _random_batch()
    jg = jmake_graph_batch(*arrays)
    model = jbuild_model("resgcn", hidden_channels=16, n_layers=2)
    vs = init_model(model, jr.PRNGKey(0), jg)
    r = np.random.RandomState(1)
    vs = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.randn(*np.shape(a))).astype(
            np.float32), vs)
    vs["batch_stats"]["in_norm"]["var"] = (
        np.abs(vs["batch_stats"]["in_norm"]["var"]) + 0.5)
    want = np.asarray(japply_model(model, vs, jg))
    tg = gt.make_graph_batch(*arrays)
    with torch.no_grad():
        got = convert.resgcn_from_jax(vs)(tg).numpy()
    valid = arrays[4] > 0
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got[valid], want[valid],
                               atol=LOGITS_TOL * scale)


def test_ensemble_from_bgc_checkpoints_matches_jax():
    """The real 3-member bgc ensemble, both loaders, on a graph the JAX
    build made (bg_connectivity, K = 484, B = 2)."""
    rgbs = jnp.asarray(np.stack([image(0), image(1)]), jnp.float32)
    out = jgb.build_graph_batch_arrays(
        rgbs, jgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS,
                                        bg_connectivity=True))
    keys = ("x", "edge_src", "edge_dst", "edge_attr", "node_mask",
            "edge_mask", "node_area")
    arrays = [np.array(out[k]) for k in keys]
    jmodel, jvars, jmeta = jload(ENSEMBLE)
    want = np.asarray(jax.nn.softmax(
        japply_model(jmodel, jvars, jmake_graph_batch(*arrays)), -1))
    tmodel, tmeta = gt.load_model_auto(ENSEMBLE, device="cpu")
    assert tmeta["ensemble_size"] == jmeta["ensemble_size"] == 3
    assert isinstance(tmodel, gt.ResGCNEnsemble)
    got = gt.predict_probs(tmodel, gt.make_graph_batch(*arrays)).numpy()
    assert got.shape == want.shape == (2, K, 3)
    valid = arrays[4] > 0
    np.testing.assert_allclose(got[valid], want[valid],
                               atol=ENSEMBLE_PROBS_TOL)


def test_dense_knn_matches_jax(jax_stages):
    _, _, st, adj_pairs, adj_mask = jax_stages
    valid = np.array(st["valid"])
    valid[[3, 40]] = 0.0                 # empty clusters on both sides
    ml = np.array(st["mean_lab"])
    ml[7] = ml[8]                        # a tie in distance
    jp, jm = jedges.nonlocal_pairs(adj_pairs, adj_mask, jnp.asarray(ml),
                                   jnp.asarray(valid), K, 4)
    tp, tm = tedges.nonlocal_pairs(t(adj_pairs)[None], t(adj_mask)[None],
                                   t(ml)[None], t(valid)[None], K, 4)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))


@pytest.mark.parametrize("geodesic", [False, True])
def test_dense_prior_matches_jax(jax_stages, geodesic):
    segments, lab, st, adj_pairs, adj_mask = jax_stages
    stats = (st["counts"], st["mean_lab"], st["centroids"])
    geo_iters = min(int(2 * K ** 0.5) + 8, 96) if geodesic else 0
    adjacency = (adj_pairs, adj_mask) if geodesic else None
    want = np.asarray(jprior.compute_auto_prior(
        segments, lab, K, stats=stats, adjacency=adjacency,
        geo_iters=geo_iters))
    got = tprior.compute_auto_prior(
        t(segments).long()[None], K, stats=tuple(t(a)[None] for a in stats),
        adjacency=None if adjacency is None else tuple(
            t(a)[None] for a in adjacency), geo_iters=geo_iters)[0].numpy()
    np.testing.assert_allclose(got, want, atol=PRIOR_TOL)


def _relax_reference(w, src, dst, d0, n_iters):
    """Order-free min-plus relaxation, one edge at a time in float32."""
    d = d0.copy()
    for _ in range(n_iters):
        incoming = np.full_like(d, np.inf)
        for s_, t_, w_ in zip(src, dst, w):
            incoming[t_] = min(incoming[t_], np.float32(d[s_] + w_))
        d = np.minimum(d, incoming)
    return d


def test_geodesic_prior_matches_jax(jax_stages):
    segments, _, st, adj_pairs, adj_mask = jax_stages
    seg = np.asarray(segments)
    border = np.bincount(np.concatenate([seg[0], seg[-1], seg[:, 0],
                                         seg[:, -1]]),
                         minlength=K).astype(np.float32)
    ml, valid = np.asarray(st["mean_lab"]), np.asarray(st["valid"])
    pairs, pmask = np.asarray(adj_pairs), np.asarray(adj_mask)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    # JAX's edge weights: jnp.linalg.norm, as boundary_connectivity_bg has.
    w = np.maximum(np.asarray(jnp.linalg.norm(
        jnp.asarray(ml[src] - ml[dst]), axis=1)) - np.float32(8.0),
        np.float32(0.0))
    w = np.where(np.concatenate([pmask, pmask]) > 0, w, np.float32(1e30))
    d0 = np.where((border > 0) & (valid > 0), 0.0, 1e30).astype(np.float32)
    for n_iters in (1, 5, 52):
        want = np.asarray(jprior.boundary_connectivity_bg(
            adj_pairs, adj_mask, st["mean_lab"], jnp.asarray(border),
            st["valid"], K, n_iters))
        args = tuple(t(a)[None] for a in (adj_pairs, adj_mask, ml, border,
                                          valid)) + (K, n_iters)
        # The distances are exact: a min is order-free.
        np.testing.assert_array_equal(
            tprior.geodesic_distance(*args)[0].numpy(),
            _relax_reference(w, src, dst, d0, n_iters))
        got = tprior.boundary_connectivity_bg(*args)[0].numpy()
        # The weights within the exp's rounding.
        np.testing.assert_allclose(got, want, atol=PRIOR_TOL, rtol=0)
    assert 0 < (want > 0.5).mean() < 1


@pytest.mark.parametrize("hw_in,hw_out,channels",
                         [(512, 384, 3), (384, 512, 2), (128, 96, 3),
                          (96, 128, 2), (100, 70, 1)])
def test_resize_bilinear_matches_jax(hw_in, hw_out, channels):
    """As the multi-scale path uses it: RGB in 0..255 downsampled
    (antialiased), posterior planes in [0, 1] upsampled."""
    r = np.random.RandomState(hw_in + hw_out)
    x = r.rand(2, hw_in, hw_in + 8, channels).astype(np.float32)
    if hw_out < hw_in:
        x *= 255
    out_hw = (hw_out, hw_out + 6)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (2, *out_hw, channels), "linear"))
    got = tim.resize_bilinear(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL)
