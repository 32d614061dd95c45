"""The control, the reference computed in the nearest lower precision in
the program's place, comes out not correct: on the CPU at a tiny size,
and (marked `cuda`, skipped elsewhere) on the card at each cell's own
size, where a sound short run of the cell also comes out correct."""

import time

import pytest
import torch

from bench_port import harness
from bench_port.tests.test_bench_port_faults import tiny_cell

CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


def fails(numbers: dict, limits: dict) -> bool:
    return not harness.checked(numbers, limits)[0]


def test_control_fails_on_the_cpu():
    cell = tiny_cell()
    limits = harness.load_json(harness.limits_file("dense512_ens3.batch8"))
    out = harness.load_driver(cell.traffic["kind"]).run(
        cell, lambda: None, torch.device("cpu"), control=True)
    assert not fails(out.numbers, limits), out.numbers
    assert fails(out.control_numbers, limits), out.control_numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = harness.load_cell(name, 20240601, 5.0, False)
    limits = harness.load_json(harness.limits_file(name))
    t = time.perf_counter()
    out = harness.load_driver(cell.traffic["kind"]).run(
        cell, lambda: None, card, control=True)
    assert out.attempted > 0 and out.failed == 0
    assert not fails(out.numbers, limits), out.numbers
    assert fails(out.control_numbers, limits), out.control_numbers
    assert time.perf_counter() - t < 360
