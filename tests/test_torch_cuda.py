"""Tests that need an NVIDIA GPU and nvcc: the hand-written kernels against
their plain versions, and the port's pipeline on the card against its CPU
path.  Each skips without CUDA.  The file imports no JAX, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import gcn_grabcut_torch as gt
from gcn_grabcut_torch.ops import spmm

pytestmark = pytest.mark.cuda

SPMM_TOL = 1e-4   # same products as the plain version, fp32 sums reordered


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def banded_plan(n, dtype, device, seed=9):
    r = np.random.RandomState(seed)
    src = r.randint(0, n, 6 * n)
    dst = np.clip(src + r.randint(-200, 200, src.size), 0, n - 1)
    src = np.concatenate([src, r.randint(0, n, n // 10)])
    dst = np.concatenate([dst, r.randint(0, n, n // 10)])
    w = r.rand(src.size).astype(np.float32)
    plan = spmm.spmm_plan_device(
        torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
        torch.from_numpy(w).to(device), n, window=512, dtype=dtype)
    return plan, (src, dst, w)


@pytest.mark.parametrize("d", [16, 128, 200])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_spmm_kernel_matches_plain(cuda, dtype, d):
    n = 1000                      # < n_pad: the kernel's row guard
    plan, _ = banded_plan(n, dtype, cuda)
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
