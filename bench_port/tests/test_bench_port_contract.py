"""BENCHMARK.json against the benchmark contract, and every file it names
present under bench_port/."""

import json
import re

import pytest

from bench_port import harness

BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir()
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["source"].startswith("https://")
    assert conf["file"].startswith("bench_port/")
    assert len(conf["reduced"]) <= 16
    data = json.loads((harness.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and "assumed" in data
    for ckpt in data["checkpoints"]:
        assert (harness.ROOT / ckpt).is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells(cell):
    w = CELLS[cell]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    traffic = harness.load_json(harness.traffic_file(w["traffic"]))
    assert (harness.HERE / "drivers" / f"{traffic['kind']}.py").is_file()
    limits = harness.load_json(harness.limits_file(cell))
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m for m in BENCH["end_to_end"] if reports(cell, m)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert any(reports(cell, m) for m in BENCH["per_layer"])


def test_end_to_end_metrics():
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", []):
            assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metrics(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", sorted(CELLS)):
        assert cell in CELLS
        assert reports(cell, moved), (metric["name"], cell)
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert layer == layer.strip() and 1 <= len(layer) <= 200
