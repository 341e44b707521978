"""What a run may load, and how run.py refuses to run."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, make_tiny_base

FORBIDDEN = {"jax", "jaxlib", "flax", "isle_tpu", "bench", "benchmarks"}


def _python(code: str, cwd: str = ROOT, path: str = ROOT):
    env = dict(os.environ, PYTHONPATH=path)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    base = make_tiny_base(str(tmp_path / "portbench"))
    code = f"""
import json, sys
from portbench import harness
bench = json.load(open({os.path.join(ROOT, 'BENCHMARK.json')!r}))
for wl in bench["workloads"]:
    r = harness.run_cell(bench, wl["name"], 5, 0.5, True, "cpu",
                         base={base!r})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "isle_tpu_torch" in loaded  # the program ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_and_the_yardstick_load_nothing_of_the_program():
    code = """
import json, sys
import portbench.reference.train_ref, portbench.reference.infer_ref
import portbench.gen.inputs, portbench.yardstick, portbench.trace
import portbench.readers
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"isle_tpu_torch"})


def test_run_without_a_card_exits_2_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nytimes-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A checkout of only BENCHMARK.json and portbench/ lacks the program:
    a run there fails before any result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = """
import json
from portbench import harness
bench = json.load(open("BENCHMARK.json"))
print(json.dumps(harness.run_cell(bench, "nytimes-train", 1, 0.5, False,
                                  "cpu")))
"""
    proc = _python(code, cwd=str(tmp_path), path=str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "isle_tpu_torch" in proc.stderr
