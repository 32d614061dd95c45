"""The reader of the program's colour-model pass counter, on a stand-in
for ``ops.gmm.counts`` and on a program that keeps no such counter."""

import sys
import types

import pytest

from bench_port import harness
from bench_port.trace import Trace


def read(rec):
    return harness.load_reader("gmm_passes_per_image").read(rec)


def record(images):
    return harness.Record(Trace([], {}, []), images, {}, {})


def test_passes_per_image_entering_grabcut(monkeypatch):
    from gcn_grabcut_torch.ops import gmm
    stand_in = types.SimpleNamespace(passes=[("seed", 8)] * 27 * 2)
    monkeypatch.setattr(gmm, "counts", stand_in)
    assert read(record({"layer.grabcut": 16})) == pytest.approx(27 / 8)
    assert read(record({})) is None
    stand_in.passes = []
    assert read(record({"layer.grabcut": 16})) is None


def test_nothing_without_the_counter(monkeypatch):
    monkeypatch.setitem(sys.modules, "gcn_grabcut_torch.ops.gmm",
                        types.SimpleNamespace())
    assert read(record({"layer.grabcut": 8})) is None
    monkeypatch.delitem(sys.modules, "gcn_grabcut_torch.ops.gmm")
    assert read(record({"layer.grabcut": 8})) is None
