"""Port parity: connected components and the mask clean-up over a batch,
against the JAX package image by image, exactly.

`connected_components` and `_clean_mask` take (B, H, W) masks; on the CPU
the components run the plain version of csrc/mask_components.cu, whose
sweeps stop when the batch's sweep changes nothing, and the clean-up's
branches are per-image reductions.  A batch mixes images whose clean-up
takes different branches, so a reduction over the whole batch would show.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chip_smoke import serpentine_mask
from gcn_grabcut_tpu.ops import connected as jcc
from gcn_grabcut_torch.ops import connected as tcc

torch.set_num_threads(1)

HW = 96


def blobs(seed: int, n: int = 12, r_max: int = 12) -> np.ndarray:
    """Discs of seeded centres and radii 1..r_max, some touching."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:HW, 0:HW]
    m = np.zeros((HW, HW), bool)
    for _ in range(n):
        cy, cx, rad = r.randint(0, HW), r.randint(0, HW), r.randint(1, r_max)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rad ** 2
    return m


def frame(hw: int = HW, width: int = 4) -> np.ndarray:
    m = np.zeros((hw, hw), bool)
    m[:width], m[-width:], m[:, :width], m[:, -width:] = True, True, True, True
    return m


def tiny_specks(seed: int) -> np.ndarray:
    """Only components of one to four pixels: none reaches min_area."""
    r = np.random.RandomState(seed)
    m = np.zeros((HW, HW), bool)
    for _ in range(30):
        y, x = r.randint(0, HW - 2), r.randint(0, HW - 2)
        m[y:y + r.randint(1, 3), x:x + r.randint(1, 3)] = True
    return m


def jax_components(m, **kw):
    return np.asarray(jcc.connected_components(jnp.asarray(m), **kw))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_iters", [2, 512])
def test_components_match_jax(connectivity, max_iters):
    """The serpentine stops at the cap of 2 sweeps; the blobs converge
    first, beside it."""
    batch = np.stack([serpentine_mask(HW), blobs(0), blobs(1, n=30, r_max=5)])
    got = tcc.connected_components(torch.from_numpy(batch), connectivity,
                                   max_iters)
    assert got.dtype == torch.int32 and got.shape == batch.shape
    for b in range(len(batch)):
        np.testing.assert_array_equal(
            got[b].numpy(), jax_components(batch[b],
                                           connectivity=connectivity,
                                           max_iters=max_iters))


def test_serpentine_hits_the_cap():
    m = torch.from_numpy(serpentine_mask(HW))[None]
    capped = tcc.connected_components(m, max_iters=2)
    full = tcc.connected_components(m)
    assert not torch.equal(capped, full)
    assert len(torch.unique(full[full < HW * HW])) == 1


def jax_clean(m, min_area, keep_largest, post=None):
    return np.asarray(jcc._clean_mask_jit(
        jnp.asarray(m.astype(np.uint8)), jnp.float32(min_area), keep_largest,
        None if post is None else jnp.asarray(post)))


CASES = {
    "blobs": lambda: blobs(2),
    "no_component_reaches_min_area": lambda: tiny_specks(3),
    "frame_only": frame,
    "frame_and_blobs": lambda: frame() | blobs(4, n=6, r_max=8),
}


@pytest.mark.parametrize("mode", ["min_area", "keep_largest", "posterior"])
def test_clean_mask_batch_matches_jax(mode):
    """Every case in one batch: each image's branch (some component kept
    by area, none reaching it, the frame demoted or the only one) is
    decided by its own reductions."""
    batch = np.stack([f() for f in CASES.values()]).astype(np.uint8)
    min_area = 40.0
    keep_largest = mode != "min_area"
    post = None
    if mode == "posterior":
        post = np.random.RandomState(5).rand(*batch.shape).astype(np.float32)
    got = tcc._clean_mask(torch.from_numpy(batch), min_area, keep_largest,
                          None if post is None else torch.from_numpy(post))
    assert got.dtype == torch.uint8
    for b in range(len(batch)):
        want = jax_clean(batch[b], min_area, keep_largest,
                         None if post is None else post[b])
        np.testing.assert_array_equal(got[b].numpy(), want,
                                      err_msg=list(CASES)[b])


def test_clean_mask_cases_take_their_branches():
    """The cases do what their names say, so the batch test covers each
    branch: the specks' largest survives though none reaches min_area,
    and keep_largest keeps the only component, a frame."""
    specks = torch.from_numpy(tiny_specks(3))[None]
    kept = tcc._clean_mask(specks, 40.0, False)
    assert 0 < int(kept.sum()) < int(specks.sum())
    only = torch.from_numpy(frame())[None]
    assert torch.equal(tcc._clean_mask(only, 40.0, True).bool(), only)
    both = torch.from_numpy(frame() | blobs(4, n=6, r_max=8))[None]
    assert not tcc._clean_mask(both, 40.0, True)[0, 0, 0]


def test_clean_mask_batch_equals_each_image_alone():
    batch = np.stack([f() for f in CASES.values()]).astype(np.uint8)
    post = np.random.RandomState(6).rand(*batch.shape).astype(np.float32)
    t, p = torch.from_numpy(batch), torch.from_numpy(post)
    got = tcc._clean_mask(t, 40.0, True, p)
    for b in range(len(batch)):
        assert torch.equal(got[b], tcc._clean_mask(t[b:b + 1], 40.0, True,
                                                   p[b:b + 1])[0])
