"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the
program."""

import subprocess
import sys

from bench_port import harness

PROBE = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {root!r} + '/bench_port')
import run
from bench_port import harness, hooks, trace, control
from bench_port.drivers import stream
from bench_port.reference import pipeline, compare
import gcn_grabcut_torch
bench = harness.load_bench()
for m in bench['per_layer']:
    harness.load_reader(m['name'])
for w in bench['workloads']:
    c = harness.load_cell(w['name'], 1, 1.0, False)
    harness.load_driver(c.traffic['kind'])
print(harness.forbidden_modules())
"""

REFERENCE_PROBE = """
import sys
sys.path.insert(0, {root!r})
from bench_port.reference import pipeline, compare
print(sorted(m for m in sys.modules
             if m.split('.')[0] == 'gcn_grabcut_torch'))
"""


def run_probe(code: str) -> str:
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_no_jax_in_a_run():
    assert run_probe(PROBE) == "[]"


def test_reference_loads_nothing_of_the_program():
    assert run_probe(REFERENCE_PROBE) == "[]"


def test_forbidden_names_compared_whole():
    mods = {"gcn_grabcut_torch": 1, "gcn_grabcut_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"jax.numpy": 1, "gcn_grabcut_tpu": 1, "flax": 1})
    assert harness.forbidden_modules(mods) == ["flax", "gcn_grabcut_tpu",
                                               "jax.numpy"]
