"""What every run shares: finding a cell's files by name, building the
program under test, the record the per-layer readers read, the check of
the outputs, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, whose file ``BENCHMARK.json`` gives, and a traffic mix,
``bench_port/traffic/<traffic>.json``, whose ``kind`` names the driver
``bench_port/drivers/<kind>.py``.  A per-layer metric is the reader
``bench_port/metrics/<name>.py``; the limits of a cell's comparison are
``bench_port/limits/<cell>.json``.  Adding a cell, a configuration, a
traffic mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: The benchmark's caches, at a fixed place inside the checkout.
CACHE = ROOT / ".bench_cache"
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gcn_grabcut_tpu")


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def traffic_file(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def limits_file(cell: str) -> Path:
    return HERE / "limits" / f"{cell}.json"


def load_driver(kind: str):
    """The module that drives traffic of this kind."""
    return importlib.import_module(f"bench_port.drivers.{kind}")


def load_reader(metric: str):
    """The per-layer metric's reader module, loaded from its file (a
    metric's name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port.metrics._{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports."""
    def applies(m):
        return cell in m.get("workloads", [cell])
    return ([m for m in bench["end_to_end"] if applies(m)],
            [m for m in bench["per_layer"] if applies(m)])


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole (``gcn_grabcut_torch`` is not ``gcn_grabcut``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


def seed_words(seed: int, n: int) -> list:
    """`n` 32-bit words drawn from any whole-number seed (the driver's
    run past 2**31)."""
    import numpy as np
    return [int(w) for w in
            np.random.SeedSequence(abs(int(seed))).generate_state(n)]


class Stages:
    """Seconds each named set-up stage took, in order."""

    def __init__(self):
        import time
        self._clock = time.perf_counter
        self._last = self._clock()
        self.times: dict = {}

    def mark(self, name: str) -> None:
        now = self._clock()
        self.times[name] = now - self._last
        self._last = now


@dataclasses.dataclass
class Cell:
    """One run's cell, its configuration and traffic, and the arguments."""
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    chips: int


def load_cell(name: str, seed: int, seconds: float, trace: bool,
              root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    work = find(bench["workloads"], name, "workload")
    conf = find(bench["configs"], work["config"], "config")
    config = load_json(root / conf["file"])
    traffic = load_json(traffic_file(work["traffic"]))
    return Cell(name, config, traffic, seed, seconds, trace, work["chips"])


@dataclasses.dataclass
class Record:
    """What a traced run leaves for the per-layer readers.

    `trace`: the reduced profiler window (`trace.Trace`); `images`: images
    entering each layer span in it; `counters`: the hooks' other counts
    (mincut_bytes, gcn_flops);
    `peaks`: the published peaks (`count/peaks.json`)."""
    trace: object
    images: dict
    counters: dict
    peaks: dict

    def __post_init__(self):
        self._span_s = self.trace.span_device_s()

    def device_s(self, span: str) -> float | None:
        return self._span_s.get(span)

    def per_image_ms(self, span: str, images_of: str | None = None
                     ) -> float | None:
        n = self.images.get(images_of or span, 0)
        t = self.device_s(span)
        if not n or t is None:
            return None
        return 1e3 * t / n

    def idle_share_pct(self) -> float | None:
        w = self.trace.window_s()
        if w <= 0 or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / w)


def peaks() -> dict:
    """The published peaks the rooflines and MFU are read against."""
    return load_json(HERE / "count" / "peaks.json")


def load_pipeline(config: dict, device):
    """The program under test at the configuration: its model read from
    the checkpoints by the program's own loader, its pipeline."""
    import gcn_grabcut_torch as gt
    paths = [str(ROOT / p) for p in config["checkpoints"]]
    model, _ = gt.load_model_auto(",".join(paths), device=device)
    return gt.GCNGrabCutPipeline(
        model, gt.SuperpixelGraphConfig(
            n_segments=config["n_segments"],
            bg_connectivity=config["bg_connectivity"]), device=device)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values it measured, the
    work attempted and failed in the window, the numbers its check
    compared, for a traced run the per-layer `Record`, and when asked the
    same numbers with the control (the reference in the lower precision)
    in place of the reference; `extra` holds diagnostics (set-up stages,
    the window's rate) that no metric reads."""
    e2e: dict
    attempted: int
    failed: int
    numbers: dict
    memory_peak_bytes: int
    record: Record | None = None
    control_numbers: dict | None = None
    extra: dict = dataclasses.field(default_factory=dict)


def settings(config: dict, traffic: dict) -> dict:
    """The call settings the reference needs: the configuration's graph,
    threshold, filter and clean-up settings and the traffic's scales."""
    return {"n_segments": config["n_segments"],
            "bg_connectivity": config["bg_connectivity"],
            "threshold": config["threshold"],
            "filter_radius": config["filter_radius"],
            "min_area_ratio": config["min_area_ratio"],
            "ms_scales": tuple(traffic.get("ms_scales") or (1.0,))}


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    """Peak bytes allocated on the card so far (0 off the card)."""
    import torch
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def free_cache(device) -> None:
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def checked(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every value at or under its limit, {name: {value, limit}}).  A
    value that is missing (None) fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        out[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, out
