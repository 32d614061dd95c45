#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the chip.

    python3 bench_port/control.py --workload <cell> --seeds 11,12,...
                                  [--seconds 3]

For each seed, in one process: a short window of the cell as the
benchmark runs it (the same inputs, entry and sizes), then every compared
number twice, once against the plain reference (a sound run: the lower
reading is the largest over the seeds) and once against the control, the
reference computed in the nearest lower precision (the upper reading is
the smallest over the seeds).  Prints one JSON line per seed and a
summary line last.  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell_name: str, seeds: list, seconds: float, device) -> dict:
    from bench_port import harness
    program, control = [], []
    for seed in seeds:
        cell = harness.load_cell(cell_name, seed, seconds, False)
        t = time.perf_counter()
        out = harness.load_driver(cell.traffic["kind"]).run(
            cell, lambda: None, device, control=True)
        program.append(out.numbers)
        control.append(out.control_numbers)
        print(json.dumps({"seed": seed, "program": out.numbers,
                          "control": out.control_numbers,
                          "attempted": out.attempted, "failed": out.failed,
                          "s": time.perf_counter() - t}), flush=True)
    names = sorted({k for n in program + control for k in n})

    summary = {}
    for name in names:
        summary[name] = {
            "lower": max((r[name] for r in program if name in r),
                         default=None),
            "upper": min((r[name] for r in control if name in r),
                         default=None)}
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = readings(args.workload, seeds, args.seconds,
                       torch.device("cuda", 0))
    print(json.dumps({"workload": args.workload, "seeds": seeds,
                      "card": torch.cuda.get_device_name(0),
                      "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
