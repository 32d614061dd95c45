"""Port parity: the graph build of gcn_grabcut_torch against the JAX
package, at 320x320 with n_segments=2600 (K = 2601 > 2048, so both sides
take the blocked k-NN and blocked prior branches of the large path).

SLIC labels are compared by agreement (argmin ties can flip under another
float32 summation order); everything downstream of SLIC is compared on the
JAX package's own segments.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gcn_grabcut_tpu import graph_build as jgb
from gcn_grabcut_tpu.ops import edges as jedges
from gcn_grabcut_tpu.ops import image as jim
from gcn_grabcut_tpu.ops import prior as jprior
from gcn_grabcut_tpu.ops import slic as jslic
from gcn_grabcut_torch import graph_build as tgb
from gcn_grabcut_torch.ops import edges as tedges
from gcn_grabcut_torch.ops import image as tim
from gcn_grabcut_torch.ops import prior as tprior
from gcn_grabcut_torch.ops import slic as tslic

torch.set_num_threads(1)

ATOL = 1e-4
H = W = 320
N_SEGMENTS = 2600


def blob_image(seed=5):
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (r.rand(H, W, 3) * 80).astype(np.uint8)
    blob = ((yy - 160) ** 2 + (xx - 150) ** 2) < 90 ** 2
    img[blob] = (200 + r.rand(blob.sum(), 3) * 50).astype(np.uint8)
    return img


@pytest.fixture(scope="module")
def builds():
    img = blob_image()
    jcfg = jgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    jout = jgb._build_graph_arrays(
        jnp.asarray(img, jnp.float32), jcfg.n_segments, jcfg.compactness,
        jcfg.sigma, jcfg.connectivity, jcfg.n_nonlocal, jcfg.slic_iters)
    jout = {k: np.array(v) for k, v in jout.items()}
    tcfg = tgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    rgb = torch.from_numpy(img).float()[None]
    tout = {k: v[0] for k, v in tgb.build_graph_batch_arrays(
        rgb, tcfg, device="cpu").items()}
    # Everything after SLIC, on the JAX segments.
    lab = torch.from_numpy(np.array(jim.rgb_to_lab(jnp.asarray(
        img, jnp.float32))))[None]
    tgiven = tgb._graph_arrays(rgb, lab, torch.from_numpy(
        jout["segments"]).long()[None], tcfg)
    return img, jout, tout, {k: v[0].numpy() for k, v in tgiven.items()}


def test_sizes_and_budgets_match():
    jcfg = jgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    tcfg = tgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS)
    for h, w in ((H, W), (1536, 1536), (240, 321)):
        assert tslic.grid_shape(h, w, N_SEGMENTS) == jslic.grid_shape(
            h, w, N_SEGMENTS)
        assert tgb.num_nodes_for(h, w, tcfg) == jgb.num_nodes_for(h, w, jcfg)
        assert tgb.edge_budget_for(h, w, tcfg) == jgb.edge_budget_for(
            h, w, jcfg)


def test_slic_label_agreement(builds):
    _, jout, tout, _ = builds
    agree = float((tout["segments"].numpy() == jout["segments"]).mean())
    print(f"SLIC label agreement with JAX: {agree:.6f}")
    assert tout["segments"].max() < tgb.num_nodes_for(
        H, W, tgb.SuperpixelGraphConfig(n_segments=N_SEGMENTS))
    assert agree >= 0.999


@pytest.mark.parametrize("key", ["x", "node_mask", "node_area", "centroids",
                                 "counts", "prior"])
def test_node_arrays_given_jax_segments(builds, key):
    _, jout, _, tgiven = builds
    assert tgiven[key].shape == jout[key].shape
    np.testing.assert_allclose(tgiven[key], jout[key], atol=ATOL)


def test_edges_given_jax_segments(builds):
    _, jout, _, tgiven = builds

    def edge_set(out):
        m = out["edge_mask"] > 0
        return sorted(zip(out["edge_src"][m].tolist(),
                          out["edge_dst"][m].tolist()))

    assert tgiven["edge_src"].shape == jout["edge_src"].shape
    assert edge_set(tgiven) == edge_set(jout)
    np.testing.assert_array_equal(tgiven["edge_mask"], jout["edge_mask"])
    np.testing.assert_allclose(tgiven["edge_attr"], jout["edge_attr"],
                               atol=ATOL)


def test_colour_and_filter_ops_match():
    r = np.random.RandomState(0)
    rgb = (r.rand(40, 56, 3) * 255).astype(np.float32)
    rgb[5:9, 5:9] = 128.0        # grey patch: zero saturation branch
    j, t = jnp.asarray(rgb), torch.from_numpy(rgb)
    for jf, tf in ((jim.rgb_to_lab, tim.rgb_to_lab),
                   (jim.rgb_to_hsv, tim.rgb_to_hsv),
                   (jim.rgb_to_gray, tim.rgb_to_gray)):
        np.testing.assert_allclose(tf(t).numpy(), np.asarray(jf(j)),
                                   atol=ATOL)
    gray = jim.rgb_to_gray(j) / 255.0
    tgray = tim.rgb_to_gray(t) / 255.0
    np.testing.assert_allclose(tim.gradient_magnitude(tgray).numpy(),
                               np.asarray(jim.gradient_magnitude(gray)),
                               atol=ATOL)
    src = r.rand(40, 56).astype(np.float32)
    for radius in (1, 4):
        np.testing.assert_allclose(
            tim.box_filter(torch.from_numpy(src), radius).numpy(),
            np.asarray(jim.box_filter(jnp.asarray(src), radius)), atol=1e-5)
        np.testing.assert_allclose(
            tim.guided_filter(tgray, torch.from_numpy(src), radius).numpy(),
            np.asarray(jim.guided_filter(gray, jnp.asarray(src), radius)),
            atol=ATOL)


def test_blocked_knn_matches_jax():
    r = np.random.RandomState(3)
    k = 600
    ml = (r.rand(k, 3) * 100).astype(np.float32)
    valid = np.ones(k, np.float32)
    valid[50:80] = 0.0
    jp, jm = jedges.nonlocal_pairs_banded(jnp.asarray(ml), jnp.asarray(valid),
                                          k, 4, exclude_window=25, block=256)
    tp, tm = tedges.nonlocal_pairs_banded(torch.from_numpy(ml)[None],
                                          torch.from_numpy(valid)[None], k, 4,
                                          exclude_window=25, block=256)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp))


def test_blocked_contrast_matches_jax():
    r = np.random.RandomState(0)
    k = 2500
    ml = (r.rand(k, 3) * 100).astype(np.float32)
    ct = r.rand(k, 2).astype(np.float32)
    aw = r.rand(k).astype(np.float32)
    aw /= aw.sum()
    j = np.asarray(jprior._contrast_blocked(
        jnp.asarray(ml), jnp.asarray(ct), jnp.asarray(aw), k, 0.4))
    t = tprior._contrast_blocked(torch.from_numpy(ml)[None],
                                 torch.from_numpy(ct)[None],
                                 torch.from_numpy(aw)[None], k, 0.4)[0].numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)

