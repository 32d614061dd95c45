"""Port parity: gcn_grabcut_torch.ops.spmm (kernel K1's module) against the
JAX package's ops/spmm.py.

The JAX side runs as its own tests run it (``interpret=True``: the XLA
shifted-view path in exact fp32, or the default bf16 path); the port runs
its plain version on the CPU.  The hand-written CUDA kernel itself is held
against the plain version by tests/test_torch_cuda.py, which needs a card,
and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gcn_grabcut_tpu.ops import spmm as jspmm
from gcn_grabcut_tpu.models import large as jlarge
from gcn_grabcut_torch.ops import spmm as tspmm
from gcn_grabcut_torch.models import large as tlarge

torch.set_num_threads(1)

ATOL = 1e-4           # fp32 paths: same products, other summation order
BF16_REL = 2e-2       # tests/test_spmm.py::test_bf16_default_path_tolerance


def _random_banded(n, e_local, e_far, seed=0, band=200):
    r = np.random.RandomState(seed)
    src_l = r.randint(0, n, e_local)
    dst_l = np.clip(src_l + r.randint(-band, band, e_local), 0, n - 1)
    src = np.concatenate([src_l, r.randint(0, n, e_far)])
    dst = np.concatenate([dst_l, r.randint(0, n, e_far)])
    w = r.rand(len(src)).astype(np.float32)
    return src, dst, w


def _both(src, dst, w, n, x, window=512, block_rows=128):
    """(port plain output, JAX interpret output, JAX scatter oracle)."""
    jplan = jspmm.spmm_plan(src, dst, w, n, block_rows=block_rows,
                            window=window)
    tplan = tspmm.spmm_plan(src, dst, w, n, block_rows=block_rows,
                            window=window)
    xt = torch.from_numpy(x)
    out = tspmm.banded_spmm(xt, tplan).numpy()
    jout = np.asarray(jspmm.banded_spmm(jnp.asarray(x), jplan,
                                        interpret=True))
    ref = np.asarray(jspmm.spmm_reference(jnp.asarray(x), src, dst, w, n))
    return out, jout, ref


CASES = {
    "small": (256, 1500, 50),
    "wide": (1024, 6000, 200),
    "no_far_edges": (700, 4000, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_and_oracle(case):
    n, e_local, e_far = CASES[case]
    src, dst, w = _random_banded(n, e_local, e_far, seed=n)
    x = np.random.RandomState(1).randn(n, 64).astype(np.float32)
    out, jout, ref = _both(src, dst, w, n, x)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    torch_ref = tspmm.spmm_reference(torch.from_numpy(x), src, dst, w, n)
    np.testing.assert_allclose(torch_ref.numpy(), ref, atol=ATOL)


def test_duplicate_edges_accumulate():
    src = np.array([3, 3, 3, 900])
    dst = np.array([7, 7, 7, 7])
    w = np.array([1.0, 2.0, 4.0, 0.5], np.float32)
    x = np.zeros((1024, 8), np.float32)
    x[3] = 1.0
    x[900] = 2.0
    out, jout, ref = _both(src, dst, w, 1024, x)
    np.testing.assert_allclose(out[7], np.full(8, 8.0))
    np.testing.assert_allclose(out, jout, atol=ATOL)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_empty_graph():
    e = np.zeros(0, int)
    x = np.ones((128, 32), np.float32)
    out, jout, _ = _both(e, e, np.zeros(0, np.float32), 128, x)
    assert np.abs(out).max() == 0.0 and np.abs(jout).max() == 0.0


def test_all_edges_out_of_window():
    n = 1024
    src = np.zeros(500, int)
    dst = np.full(500, n - 1)
    w = np.ones(500, np.float32)
    plan = tspmm.spmm_plan(src, dst, w, n, block_rows=128, window=128)
    assert plan.fb_src.numel() == 500 and float(plan.band.abs().sum()) == 0
    x = np.random.RandomState(0).randn(n, 32).astype(np.float32)
    out, jout, ref = _both(src, dst, w, n, x, window=128)
    np.testing.assert_allclose(out, jout, atol=ATOL)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_bf16_path_matches_jax_default():
    """bf16 band and x, fp32 accumulation: against JAX's default (bf16)
    path and the oracle, at the JAX package's bf16 tolerance."""
    n = 512
    src, dst, w = _random_banded(n, 3000, 100, seed=5)
    x = np.random.RandomState(7).randn(n, 32).astype(np.float32)
    jplan = jspmm.spmm_plan(src, dst, w, n)
    tplan = tspmm.spmm_plan(src, dst, w, n, dtype=torch.bfloat16)
    assert tplan.band.dtype == torch.bfloat16
    out = tspmm.banded_spmm(torch.from_numpy(x), tplan).numpy()
    jout = np.asarray(jspmm.banded_spmm(jnp.asarray(x), jplan,
                                        precision="default", backend="xla"))
    ref = np.asarray(jspmm.spmm_reference(jnp.asarray(x), src, dst, w, n))
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() / scale < BF16_REL
    assert np.abs(out - jout).max() / scale < BF16_REL


def test_plan_device_band_matches_numpy_plan():
    n = 900
    src, dst, w = _random_banded(n, 4000, 200, seed=11)
    jhost = jspmm.spmm_plan(src, dst, w, n, block_rows=128, window=384)
    thost = tspmm.spmm_plan(src, dst, w, n, block_rows=128, window=384)
    tdev = tspmm.spmm_plan_device(torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(w), n, block_rows=128,
                                  window=384)
    assert (tdev.n_nodes, tdev.k_blocks) == (jhost.n_nodes, jhost.k_blocks)
    np.testing.assert_allclose(thost.band.numpy(), jhost.band, atol=1e-6)
    np.testing.assert_allclose(tdev.band.numpy(), thost.band.numpy(),
                               atol=1e-5)
    np.testing.assert_array_equal(thost.fb_dst.numpy(), jhost.fb_dst)
    np.testing.assert_allclose(float(tdev.fb_weight.sum()),
                               jhost.fb_weight.sum(), rtol=1e-5)
    assert bool((torch.diff(tdev.fb_dst) >= 0).all())


def test_masked_edges_contribute_nothing():
    n = 256
    src = np.array([1, 2, 3, 200])
    dst = np.array([2, 3, 4, 10])
    w = np.array([1.0, 0.0, 2.0, 0.0], np.float32)
    plan = tspmm.spmm_plan_device(torch.from_numpy(src),
                                  torch.from_numpy(dst),
                                  torch.from_numpy(w), n, window=128)
    x = torch.from_numpy(np.random.RandomState(1).randn(n, 16)
                         .astype(np.float32))
    ref = tspmm.spmm_reference(x, src, dst, w, n)
    np.testing.assert_allclose(tspmm.banded_spmm(x, plan).numpy(),
                               ref.numpy(), atol=ATOL)


def test_gcn_plans_match_jax():
    r = np.random.RandomState(3)
    n, e = 500, 3000
    src = r.randint(0, n, e)
    dst = np.clip(src + r.randint(-80, 80, e), 0, n - 1)
    mask = (r.rand(e) > 0.2).astype(np.float32)
    jplans = jlarge.build_gcn_plans(src, dst, mask, n, window=384)
    thost = tlarge.build_gcn_plans(src, dst, mask, n, window=384)
    tdev = tlarge.build_gcn_plans_device(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), n, window=384)
    x = r.randn(jplans[0].n_nodes, 32).astype(np.float32)
    for jp, hp, dp in zip(jplans, thost, tdev):
        np.testing.assert_allclose(hp.band.numpy(), jp.band, atol=1e-6)
        np.testing.assert_allclose(dp.band.numpy(), jp.band, atol=1e-5)
        jout = np.asarray(jspmm.banded_spmm(jnp.asarray(x), jp,
                                            interpret=True))
        out = tspmm.banded_spmm(torch.from_numpy(x), dp).numpy()
        np.testing.assert_allclose(out, jout, atol=ATOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    n = 300
    src, dst, w = _random_banded(n, 1000, 10, seed=4)
    plan = tspmm.spmm_plan(src, dst, w, n)
    before = tspmm.banded_spmm.kernel_launches
    x = torch.randn(n, 16)
    out = tspmm.banded_spmm(x, plan)
    assert out.shape == (n, 16) and out.dtype == torch.float32
    assert tspmm.banded_spmm.kernel_launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    band = torch.zeros(4, 256, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.banded_spmm_cuda(torch.zeros(200, 16), band)
