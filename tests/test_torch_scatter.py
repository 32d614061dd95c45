"""Port parity for core/scatter.py: every public function of
gcn_grabcut_torch.core.scatter against its twin in gcn_grabcut_tpu on the
same seeded inputs, with empty segments, masked rows, row weights and
bfloat16 scores.  Maxima are exact (an empty segment included); sums,
means, softmaxes and variances agree within 1e-6.  One shape: M = 300
rows into 40 segments, (G, N, D) = (3, 50, 8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcn_grabcut_tpu.core import scatter as js
from gcn_grabcut_torch.core import graph as tgraph
from gcn_grabcut_torch.core import scatter as ts
from gcn_grabcut_torch.models import layers as tlayers

torch.set_num_threads(1)

M, N_SEG = 300, 40
G, N, D = 3, 50, 8
TOL = 1e-6


def rows(seed, shape=(M,)):
    """Values, and an index that leaves segments 0, 7 and 39 empty."""
    r = np.random.RandomState(seed)
    index = r.randint(1, N_SEG - 1, M)
    index[index == 7] = 8
    return r.randn(*shape).astype(np.float32) * 3, index, r


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_one_home_of_neg_inf_and_masked_softmax():
    assert ts.NEG_INF == js.NEG_INF
    assert tgraph.NEG_INF is ts.NEG_INF
    assert tgraph.masked_softmax is ts.masked_softmax
    assert tlayers.masked_softmax is ts.masked_softmax


@pytest.mark.parametrize("shape", [(M,), (M, 5)])
def test_scatter_add(shape):
    v, idx, _ = rows(0, shape)
    (jv, tv), (ji, ti) = both(v), both(idx)
    close(ts.scatter_add(tv, ti, N_SEG), js.scatter_add(jv, ji, N_SEG))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(M,), (M, 5)])
def test_scatter_mean(shape, weighted):
    v, idx, r = rows(1, shape)
    w = (r.rand(M) * (r.rand(M) > 0.3)).astype(np.float32)
    (jv, tv), (ji, ti), (jw, tw) = both(v), both(idx), both(w)
    got = ts.scatter_mean(tv, ti, N_SEG, tw if weighted else None)
    want = js.scatter_mean(jv, ji, N_SEG, jw if weighted else None)
    close(got, want)
    assert float(got[0].abs().max()) == 0.0          # an empty segment


@pytest.mark.parametrize("shape", [(M,), (M, 5)])
def test_scatter_max_exact(shape):
    v, idx, _ = rows(2, shape)
    (jv, tv), (ji, ti) = both(v), both(idx)
    got = ts.scatter_max(tv, ti, N_SEG).numpy()
    want = np.asarray(js.scatter_max(jv, ji, N_SEG))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[[0, 7, 39]]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_scatter_softmax(dtype, masked):
    v, idx, r = rows(3)
    mask = (r.rand(M) > 0.25).astype(np.float32)
    mask[idx == 5] = 0.0                     # a segment masked whole
    (ji, ti), (jm, tm) = both(idx), both(mask)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jv = jnp.asarray(tv.float().numpy()).astype(getattr(jnp, dtype))
    got = ts.scatter_softmax(tv, ti, N_SEG, tm if masked else None)
    want = js.scatter_softmax(jv, ji, N_SEG, jm if masked else None)
    assert got.dtype == tv.dtype
    close(got, np.asarray(want.astype(jnp.float32)))
    if masked:
        assert float(got[torch.from_numpy(mask) == 0].abs().max()) == 0.0


def dense(seed):
    r = np.random.RandomState(seed)
    h = r.randn(G, N, D).astype(np.float32) * 2 + 1
    mask = (r.rand(G, N) > 0.3).astype(np.float32)
    mask[1] = 0.0                            # a graph with no valid node
    return h, mask


@pytest.mark.parametrize("keepdims", [True, False])
def test_masked_mean(keepdims):
    h, mask = dense(4)
    (jh, th), (jm, tm) = both(h), both(mask)
    close(ts.masked_mean(th, tm, axis=1, keepdims=keepdims),
          js.masked_mean(jh, jm, axis=1, keepdims=keepdims))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_softmax(dtype):
    h, mask = dense(5)
    s = h[..., 0]
    (jm, tm) = both(mask)
    tv = torch.from_numpy(s).to(getattr(torch, dtype))
    jv = jnp.asarray(tv.float().numpy()).astype(getattr(jnp, dtype))
    got = ts.masked_softmax(tv, tm, axis=1)
    assert got.dtype == tv.dtype
    close(got, np.asarray(js.masked_softmax(jv, jm, axis=1).astype(
        jnp.float32)))


@pytest.mark.parametrize("axis", [None, (0, 1), 0])
def test_masked_var(axis):
    h, mask = dense(6)
    (jh, th), (jm, tm) = both(h), both(mask)
    for got, want in zip(ts.masked_var(th, tm, axis=axis),
                         js.masked_var(jh, jm, axis=axis)):
        close(got, want)
