"""The generators repeat by seed and differ across seeds; the frozen copy
draws the program's generator's pixels; the fixed pool is made once."""

import numpy as np
import pytest

from bench_port import harness
from bench_port.drivers import stream
from bench_port.gen import hard_synthetic


def small_cell(name: str, seed: int, **over) -> harness.Cell:
    """The config and traffic that `name` (<config>.<traffic>) names, at
    64 px."""
    config, traffic = name.split(".")
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    tr = harness.load_json(harness.traffic_file(traffic))
    return harness.Cell(name, dict(cfg, image_size=64), dict(tr, **over),
                        seed, 2.0, False, 1)


def test_frozen_generator_draws_the_programs_pixels():
    from gcn_grabcut_torch.data.dataset import make_hard_synthetic_dataset
    want = [d["image"] for d in make_hard_synthetic_dataset(5, 80, 9)]
    got = hard_synthetic.images(5, 80, 9)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_generator_repeats_and_differs():
    a, b = hard_synthetic.images(3, 64, 5), hard_synthetic.images(3, 64, 5)
    c = hard_synthetic.images(3, 64, 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**33 + 1])
def test_stream_inputs_repeat_by_seed(seed):
    cell = small_cell("dense512_ens3.batch8", seed, pool=4, max_images=20,
                      check_images=2, check_within=6)
    p1, o1, c1 = stream.inputs(cell)
    p2, o2, c2 = stream.inputs(cell)
    assert np.array_equal(o1, o2) and c1 == c2
    assert all(np.array_equal(x, y) for x, y in zip(p1, p2))
    assert len(o1) == 20 and len(p1) == 6
    other = small_cell("dense512_ens3.batch8", seed + 1, pool=4,
                       max_images=20, check_images=2, check_within=6)
    p3, o3, _ = stream.inputs(other)
    assert not any(np.array_equal(p1[i], p3[i]) for i in (4, 5))


def test_seed_changes_the_checked_images_not_the_pool():
    a = small_cell("large1536_resgcn.stream1", 1, max_images=12)
    b = small_cell("large1536_resgcn.stream1", 2, max_images=12)
    pa, oa, ca = stream.inputs(a)
    pb, ob, cb = stream.inputs(b)
    n = a.traffic["pool"]
    assert all(np.array_equal(x, y) for x, y in zip(pa[:n], pb[:n]))
    assert not any(np.array_equal(x, y) for x, y in zip(pa[n:], pb[n:]))
    for order, check in ((oa, ca), (ob, cb)):
        assert len(check) == a.traffic["check_images"]
        assert max(check) < a.traffic["check_within"]
        assert [int(order[p]) for p in check] == list(range(n, len(pa)))
        rest = [int(i) for p, i in enumerate(order) if p not in check]
        assert sorted(rest[:n]) == list(range(n))     # the pool's first lap


def test_fixed_pool_made_once(bench_cache, monkeypatch):
    first = stream.fixed_pool(3, 48, 11)
    assert len(list(bench_cache.rglob("*.npy"))) == 1

    def no_generator(*a):
        raise AssertionError("the cached pool was made again")
    monkeypatch.setattr(hard_synthetic, "images", no_generator)
    again = stream.fixed_pool(3, 48, 11)
    assert all(np.array_equal(x, y) for x, y in zip(first, again))
