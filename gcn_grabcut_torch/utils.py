"""Tracing: named spans on the profiler's clock, and a profiler wrapper.

Counterpart of ``gcn_grabcut_tpu/utils.py`` (``profile_trace``,
``trace_span``): wrap any region in ``profile_trace`` and open the
Chrome-trace JSON it writes in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

`trace_span(name)` is the program's one way to open a span.  While a
torch profiler records (`tracing()`), it opens
``torch.profiler.record_function(name)``: the span sits on the profiler's
own clock, the device work launched inside it links to it by correlation
id, and an idle gap of the card can be labelled by the innermost span
open on the host.  Otherwise it returns one shared null context, so a
span costs a flag read.  Tracing has no switch of its own: it is on
exactly while a torch profiler records.

The spans of the batched path (`GCNGrabCutPipeline._dispatch_batch`,
`_finalize_batch` and what they call); indented names open inside the
name above them, and spans under one parent do not overlap:

    layer.upload               np.stack, the host-to-device copy and .float()
                               of the batch
    layer.build                graph_build.build_graph_batch_arrays
      layer.build.slic         Lab conversion, blur, SLIC iterations
      layer.build.connectivity kernel A (ops.slic.repair_connectivity)
      layer.build.regions      HSV, gradient, region statistics, node
                               features
      layer.build.edges        adjacency, non-local pairs, pair features,
                               symmetrise
      layer.build.prior        compute_auto_prior (the geodesic relaxation)
    layer.forward              GCNGrabCutPipeline._predict_probs_batch
      layer.forward.plan       GATTrimapNet on the large path only:
                               models.large.build_gat_plan_device, its
                               overflow read included
      layer.forward.attention  GATTrimapNet on the large path only: each
                               ops.sddmm.banded_gat_attention call
    layer.project              each _project_probs_device, the resize to a
                               reduced scale, the average of the scales
    layer.trimap               rgb_to_gray and _trimap_stage_device
    layer.grabcut              grabcut.grabcut_batch_device (and the
                               image-by-image solve above its budget)
      layer.grabcut.kmeans     _initial_components (ops.gmm's
                               class_components)
      layer.grabcut.caps       _pairwise_caps and the fresh residuals
      layer.grabcut.gmm        ops.gmm.ColourModels: the fits, the
                               component assignment and the terminal
                               capacities
      layer.mincut             ops.maxflow.grid_mincut_batch
    layer.cleanup              pipeline._post_stage_device
    layer.finalize             GCNGrabCutPipeline._finalize_batch
      layer.finalize.pull      the device-to-host copies: the batch's one
                               wait for the card
      layer.finalize.unpack    _unpack_post_host
      layer.finalize.compose   the overlay, the RGBA and the results

While a profiler records, ``ops.maxflow.counts`` also records every
min-cut solve (its kernel's tallies copied behind it, with no sync),
``ops.gmm.counts`` every colour-model pass launched (its kind and the
images it served), and ``ops.sddmm.counts`` every banded-attention plan
(its node slots, in-window, fallback and dropped edges, kept on the
device until read, and whether it was rebuilt) and call (its shape).

The JAX package's ``setup_compilation_cache`` is not ported: it points
XLA's persistent compilation cache at a directory, and the port compiles
nothing at run time but its own kernels, which ``kernels.py`` and
``native/`` already cache by source hash in ``_build/``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Iterator, Optional

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch profiler records now (torch's own flag, which
    ``torch.profiler.profile`` sets while it runs)."""
    return _autograd_profiler._is_profiler_enabled


def trace_span(name: str):
    """A context that opens the span `name` while a profiler records, else
    a shared null context (the span table: the module docstring)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


class Recorder:
    """The recording policy of the program's counters
    (``ops.maxflow.counts``, ``ops.gmm.counts``, ``ops.sddmm.counts``):
    what they count is kept after `reset()` (which clears what was kept
    and records from then on) and, without it, while a torch profiler
    records (`tracing()`), so a traced window holds what was launched in
    it.  Otherwise nothing is kept.  A subclass says in `_clear` what it
    keeps."""

    def __init__(self):
        self.recording = False
        self._clear()

    def _clear(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        """Clear the counts and record from now on."""
        self._clear()
        self.recording = True

    def clear(self) -> None:
        """Clear the counts; whether they record stays as it was."""
        self._clear()

    @property
    def active(self) -> bool:
        """Whether what is launched now is recorded."""
        return self.recording or tracing()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str | Path]) -> Iterator[None]:
    """torch.profiler trace over the wrapped region (no-op when dir is None).

    Records host activity, and the card's kernels and copies when CUDA is
    available; on exit writes ``<log_dir>/trace_<pid>_<ns>.pt.trace.json``
    in the Chrome trace format, which Perfetto opens, and beside it
    ``trace_<pid>_<ns>.mincut.json``: the min-cut solves launched in the
    region, summed (``ops.maxflow.SolverCounts.totals``: solves, rounds,
    relabel steps, grid barriers, tiles swept, tiles relaxed, host syncs),
    ``trace_<pid>_<ns>.gmm.json``: the colour-model passes launched in
    it (``ops.gmm.PassCounts.totals``: passes, images served, passes by
    kind), and ``trace_<pid>_<ns>.attention.json``: the banded-attention
    plans and calls (``ops.sddmm.AttentionCounts.totals``).  The counts are
    cleared on entry.
    """
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops import gmm, maxflow, sddmm

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    for counts in (maxflow.counts, gmm.counts, sddmm.counts):
        counts.clear()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        stem = log_dir / f"trace_{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(f"{stem}.pt.trace.json")
        Path(f"{stem}.mincut.json").write_text(
            json.dumps(maxflow.counts.totals()))
        Path(f"{stem}.gmm.json").write_text(json.dumps(gmm.counts.totals()))
        Path(f"{stem}.attention.json").write_text(
            json.dumps(sddmm.counts.totals()))
