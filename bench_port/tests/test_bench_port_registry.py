"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries: the harness finds them by name, and no file that was
there changes."""

import hashlib
import json
import shutil
import subprocess
import sys

from bench_port import harness


def digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_found_by_name(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = digests(tmp_path / "bench_port")
    bp = tmp_path / "bench_port"
    conf = json.loads((bp / "configs/dense512_ens3.json").read_text())
    conf.update(name="dense384_ens3", image_size=384)
    (bp / "configs/dense384_ens3.json").write_text(json.dumps(conf))
    (bp / "traffic/batch4.json").write_text(json.dumps(dict(
        json.loads((bp / "traffic/batch8.json").read_text()),
        batch_size=4)))
    (bp / "limits/dense384_ens3.batch4.json").write_text('{"mask_diff": 0}')
    (bp / "metrics/new.metric.py").write_text(
        "def read(rec):\n    return rec.counters['x'] * 2\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="dense384_ens3",
                                 file="bench_port/configs/dense384_ens3.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="dense384_ens3.batch4",
                                   config="dense384_ens3", traffic="batch4"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="new.metric",
                                   workloads=["dense384_ens3.batch4"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from bench_port import harness\n"
        "c = harness.load_cell('dense384_ens3.batch4', 1, 1.0, False,"
        " harness.ROOT)\n"
        "assert c.config['image_size'] == 384, c.config\n"
        "assert c.traffic['batch_size'] == 4\n"
        "assert harness.load_driver(c.traffic['kind']).run\n"
        "r = harness.Record.__new__(harness.Record)\n"
        "r.counters = {'x': 21}\n"
        "assert harness.load_reader('new.metric').read(r) == 42\n"
        "e2e, layer = harness.cell_metrics(harness.load_bench(),"
        " c.name)\n"
        "assert 'new.metric' in [m['name'] for m in layer]\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
    after = digests(bp)
    assert {k: v for k, v in after.items() if k in before} == before
