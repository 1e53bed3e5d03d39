"""Port: tools/torch_soak.py against the JAX package's tools/soak.py, on the CPU.

* The same data bytes: the writer's appends (``_synth_batch``) and the load
  client's score lines (``_score_lines``) from the same seeds, and the same
  constants (``VOCAB``, ``WIDTH``, ``K``).
* The tier-1 miniature, ``tools/torch_soak.py --device cpu --smoke
  --minutes 0.3``, held to the JAX test's gates (tests/test_soak.py): the
  trainer (``cli train --supervised --resume``) tail-follows the live
  writer while a 1-replica fleet applies its delta chain under load, with
  one trainer kill and one stream stall; every sentinel passes.
* Its artifact's keys: the committed PROBE_SOAK_r11.json's plus the device
  stamp (``ADDED_KEYS``).
* The full two-replica twin (replica kill, torn delta, stream faults) is
  marked slow, as its JAX twin is.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import tools.soak as jax_soak
import tools.torch_soak as soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_soak(tmp_path, extra_args, timeout):
    out = str(tmp_path / "probe.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_soak.py"), "--device", "cpu",
         "--out", out, *extra_args],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )
    assert os.path.isfile(out), (
        f"soak wrote no probe JSON\nstdout:\n{proc.stdout[-4000:]}"
        f"\nstderr:\n{proc.stderr[-4000:]}"
    )
    with open(out) as f:
        return proc, json.load(f)


def _assert_gates(proc, result):
    """tests/test_soak.py's gates, unchanged."""
    gates = result["gates"]
    failed = [k for k, v in gates.items() if not v]
    assert proc.returncode == 0 and result["gate"] == "OK", (
        f"soak gate {result['gate']} rc {proc.returncode}, failed {failed}\n"
        f"stdout tail:\n{proc.stdout[-4000:]}\nstderr tail:\n{proc.stderr[-3000:]}"
    )
    assert result["unanswered"] == 0
    assert result["requests_sent"] > 0
    assert result["requests_answered"] == result["requests_sent"]
    assert result["trainer_restarts"] >= 1
    assert result["stream_stalls_executed"] >= 1
    assert result["trainer_rc"] == 0
    assert result["trainer_steady_compiles"] == 0
    assert 0 <= result["max_chain_len"] <= 16


def test_constants_are_the_jax_tools():
    assert (soak.VOCAB, soak.WIDTH, soak.K) == (jax_soak.VOCAB, jax_soak.WIDTH, jax_soak.K)


@pytest.mark.parametrize("seed,rows", [(77, 1024), (1234, 512)])
def test_writer_batches_equal_the_jax_tools(seed, rows):
    a = soak._synth_batch(np.random.default_rng(seed), rows)
    b = jax_soak._synth_batch(np.random.default_rng(seed), rows)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_score_lines_equal_the_jax_tools():
    assert soak._score_lines(np.random.default_rng(9), 2048) == jax_soak._score_lines(
        np.random.default_rng(9), 2048)


def test_soak_smoke(tmp_path):
    """The tier-1 miniature: ~20 s of concurrent trainer + publisher +
    1-replica fleet under load with a live trainer kill + stream stall."""
    proc, result = _run_soak(tmp_path, ["--smoke", "--minutes", "0.3"], timeout=360)
    _assert_gates(proc, result)
    assert result["mode"] == "smoke"
    assert result["sentinel_ticks"] >= 2
    assert result["sentinel_failures"] == 0
    assert result["device"] == "cpu" and result["card"] is None
    with open(os.path.join(REPO, "PROBE_SOAK_r11.json")) as f:
        jax_art = json.load(f)
    assert set(result) == set(jax_art) | set(soak.ADDED_KEYS)
    assert set(result["gates"]) == set(jax_art["gates"])


@pytest.mark.slow
def test_soak_full_two_replicas(tmp_path):
    """The committed-probe shape at reduced length: 2 replicas, replica
    kill + torn delta + stream faults, several minutes of sustained
    concurrency."""
    proc, result = _run_soak(
        tmp_path,
        [
            "--minutes", "3", "--replicas", "2", "--qps", "150",
            "--fault-plan",
            "kill@300,torn_delta@2,replica_kill@1,stream_stall@3,append_torn@4",
        ],
        timeout=900,
    )
    _assert_gates(proc, result)
    assert result["replicas"] == 2
    assert result["torn_appends_executed"] >= 1
