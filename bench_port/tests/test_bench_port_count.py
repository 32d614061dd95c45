"""The FLOP and byte counters against hand counts on a tiny graph."""

import torch

from bench_port.count import bytes as nbytes
from bench_port.count import flops


def test_conv_flops_by_hand():
    # 3 nodes, 4 directed edges, 2 -> 5 features: the linear part 3 x 2 x 5
    # multiply-adds, the aggregation (4 edges + 3 self loops) x 5.
    assert flops.conv_flops(3, 4, 2, 5) == 2 * 30 + 2 * 35


def test_resgcn_flops_by_hand():
    n, e, d, layers = 3, 4, 2, 2
    conv = 2 * n * d * d + 2 * (e + n) * d
    assert flops.resgcn_flops(n, e, d, layers) == \
        layers * conv + conv + 2 * n * d * d
    assert flops.forward_flops(n, e, 3, d, layers) == \
        3 * flops.resgcn_flops(n, e, d, layers)


def test_forward_flops_linear_in_graphs():
    one = flops.forward_flops(484, 6000, 3, 128, 6)
    assert flops.forward_flops(8 * 484, 8 * 6000, 3, 128, 6) == 8 * one


def test_mincut_bytes_by_hand():
    B, H, W = 2, 4, 3
    plane = B * H * W
    ins = [((B, H, W), 4)] * 17            # excess, 8 forward, 8 backward
    outs = [((B, H, W), 1)] + [((B, H, W), 4)] * 17
    assert nbytes.call_bytes(ins, outs) == plane * (17 * 4 + 1 + 17 * 4)


def test_hook_counts_a_mincut_call():
    from bench_port.hooks import Hooks, _shapes
    e = torch.zeros(1, 4, 4)
    rf = tuple(torch.zeros(1, 4, 4) for _ in range(8))
    out = (torch.zeros(1, 4, 4, dtype=torch.bool), e, rf, rf)
    hooks = Hooks(None, 4, spans=False)
    hooks.counting = True
    wrapped = hooks._mincut(lambda *a, **k: out)
    wrapped(e, rf, rf, connectivity=8)
    assert hooks.mincut_bytes == 16 * (17 * 4 + 1 + 17 * 4)
    assert _shapes([e]) == [((1, 4, 4), 4)]
