"""The benchmark's tests: CPU tests, and tests marked `cuda` that need
the card (they skip elsewhere; whether there is a card is decided inside
the `card` fixture, never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def bench_cache(tmp_path, monkeypatch):
    """The benchmark's cache in a directory of the test's own."""
    from bench_port import harness
    monkeypatch.setattr(harness, "CACHE", tmp_path / "bench_cache")
    return harness.CACHE
