"""Nothing a run loads imports JAX or the JAX package: the top-level name
of every loaded module (the part before the first dot), compared whole,
so the port ``fast_tffm_tpu_torch`` passes and ``fast_tffm_tpu`` would
not."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVE = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("bench_run", "benchmark/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)  # what `python3 benchmark/run.py` executes before main
from benchmark import harness
from benchmark.tests.conftest import tiny_spec
limits = {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
for cell in ("fm2_criteo1tb.fields", "deepfm_criteo1tb.fields"):
    for trace in (False, True):
        harness.run_cell(tiny_spec(cell), 3, 0.2, trace, "cpu", time.perf_counter(),
                         limits=limits, log=lambda *a, **k: None)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fast_tffm_tpu_torch" in names and "benchmark" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fast_tffm_tpu_torch_lookalike", sys)
    assert "fast_tffm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fast_tffm_tpu.ops.fm", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"fast_tffm_tpu", "jaxlib"} <= set(harness.forbidden_modules())
