"""Shared utilities: stage timing and torch.profiler integration.

Counterpart of ``gcn_grabcut_tpu/utils.py`` (``StageTimer``,
``profile_trace``, ``trace_span``): wrap any region in ``profile_trace``
and open the Chrome-trace JSON it writes in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``, or annotate hot spans
with ``trace_span`` so they show up in the timeline.

The JAX package's ``setup_compilation_cache`` is not ported: it points
XLA's persistent compilation cache at a directory, and the port compiles
nothing at run time but its own kernels, which ``kernels.py`` and
``native/`` already cache by source hash in ``_build/``.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional


class StageTimer:
    """Accumulates named wall-clock stage timings (pipeline-style dict)."""

    def __init__(self) -> None:
        self.timing: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timing[name] = self.timing.get(name, 0.0) + (
                time.perf_counter() - t0)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str | Path]) -> Iterator[None]:
    """torch.profiler trace over the wrapped region (no-op when dir is None).

    Records host activity, and the card's kernels and copies when CUDA is
    available; on exit writes ``<log_dir>/trace_<pid>_<ns>.pt.trace.json``
    in the Chrome trace format, which Perfetto opens.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(
            log_dir / f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named span in the profiler timeline (record_function)."""
    from torch.profiler import record_function
    with record_function(name):
        yield
