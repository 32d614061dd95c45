#!/usr/bin/env python3
"""The benchmark of gcn_grabcut_torch, one cell per run.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

Loads the cell of ``BENCHMARK.json`` by name, builds the program under
test, makes its inputs from the seed, warms the cell's shapes, measures
for the given seconds and checks what the window produced against the
plain reference in ``bench_port/reference/``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same numbers close
standard error.  A run without a CUDA card, or with fewer cards than the
cell asks for, fails and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs() -> None:
    """Kernel and extension caches at fixed places inside the checkout
    (the program's own CUDA builds go to gcn_grabcut_torch/_build/)."""
    cache = ROOT / ".bench_cache"      # harness.CACHE
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def execute(cell, device, device_kind: str, chips: int, t_start: float,
            limits: dict | None = None) -> dict:
    """Run the cell (no look for a card here) and return the result;
    `limits` default to the cell's limits file."""
    from bench_port import harness
    bench = harness.load_bench()
    e2e_entries, layer_entries = harness.cell_metrics(bench, cell.name)
    if limits is None:
        limits = harness.load_json(harness.limits_file(cell.name))
    setup = {}

    def mark_setup_done():
        setup["s"] = time.perf_counter() - t_start

    driver = harness.load_driver(cell.traffic["kind"])
    out = driver.run(cell, mark_setup_done, device)
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    metrics = {}
    if cell.trace:
        rec = out.record
        for m in layer_entries:
            value = harness.load_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=setup["s"])
        for m in e2e_entries:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    ok, checks = harness.checked(out.numbers, limits)
    correct = ok and out.failed == 0 and out.attempted > 0
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    if cell.trace:
        t = out.record.trace
        device.update(busy_s=t.busy_s(), window_s=t.window_s())
        result["breakdown"] = {"device_ops": t.top_device_ops(),
                               "idle_gaps": t.idle_by_host_span()}
    if out.extra:
        print(json.dumps({"extra": out.extra}), file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_dirs()
    sys.path.insert(0, str(ROOT))
    from bench_port import harness
    cell = harness.load_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{torch.cuda.device_count()} CUDA cards, the cell needs "
              f"{cell.chips}", file=sys.stderr)
        return 2
    result = execute(cell, torch.device("cuda", 0),
                     torch.cuda.get_device_name(0), cell.chips, T_START)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
