"""Port: tools/torch_probe_tier.py against the JAX package's tools/probe_tier.py,
on the CPU.

Both probes run as a user runs them, on one small FMB (vocabulary 2^16,
batch 256, 4 steps, a 1,024-row hot tier; ``ensure_scale_fmb`` writes the
same bytes for both): the JAX probe as ``tools/probe_tier.py``, the port's
through ``bench_torch.py --tier --device cpu``.  The sample policy and the
tiered store are the JAX package's bit for bit, so these are equal:
``coverage_curve_exact``, ``hit_rate_predicted_exact``,
``hit_rate_measured``, ``dedup_ratio_mean``, ``miss_bytes_per_step``, and
``measured_train_step``'s ``examples`` and ``modeled_hbm_bytes``.  Not
compared: ``flops`` and ``bytes_accessed`` (null in the port: torch has no
compiler cost analysis) and ``wire_bytes_per_step`` (each package counts
the bytes its own staging ships).  The artifact's keys are the committed
PROBE_TIER_r12.json's plus ``ADDED_KEYS``, its nested keys the same.
"""

import json
import os
import subprocess
import sys

import pytest

from tools.torch_probe_tier import ADDED_KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--vocab", str(1 << 16), "--batch", "256", "--steps", "4", "--hot", "1024"]


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """(JAX artifact, port artifact), the two probes started together."""
    tmp = tmp_path_factory.mktemp("tier")
    # A seed of this process: ensure_scale_fmb's cache path is shared by
    # every process on the host (tempfile.gettempdir()/fmb_scale_cache).
    seed = ["--seed", str(7000 + os.getpid() % 1000)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_out, port_out = tmp / "jax.json", tmp / "port.json"
    # The JAX probe first writes the FMB; the port reads the same file.
    jax_run = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "probe_tier.py"), *ARGS, *seed,
         "--out", str(jax_out)], capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert jax_run.returncode == 0, jax_run.stderr[-4000:]
    port_run = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--tier", "--device", "cpu",
         *ARGS, *seed, "--out", str(port_out)],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert port_run.returncode == 0, port_run.stderr[-4000:]
    return json.loads(jax_out.read_text()), json.loads(port_out.read_text())


@pytest.mark.parametrize("key", ["coverage_curve_exact", "hit_rate_predicted_exact",
                                 "hit_rate_measured", "dedup_ratio_mean", "miss_bytes_per_step"])
def test_probe_equals_the_jax_probe(probes, key):
    jax_art, art = probes
    assert art[key] == jax_art[key]


def test_measured_step_and_gates(probes):
    jax_art, art = probes
    for k in ("examples", "modeled_hbm_bytes"):
        assert art["measured_train_step"][k] == jax_art["measured_train_step"][k]
    assert art["measured_train_step"]["flops"] is None
    assert art["measured_train_step"]["bytes_accessed"] is None
    assert art["hit_rate_gap"] <= 0.02 and art["steady_state_recompiles"] == 0
    assert art["workload"] == {**jax_art["workload"], "wall_s": art["workload"]["wall_s"]}
    assert art["device"] == "cpu" and art["device_memory_bytes"] > 0
    assert set(art["kernel_launches"]) == {"anova_fwd", "anova_bwd", "rows_tail_adagrad",
                                           "fused_tail_adagrad", "fm2_fwd", "fm2_bwd"}
    assert "torch has no compiler cost analysis" in art["note"]


def test_artifact_keys_are_the_jax_artifacts(probes):
    _, art = probes
    with open(os.path.join(REPO, "PROBE_TIER_r12.json")) as f:
        committed = json.load(f)
    assert set(art) == set(committed) | set(ADDED_KEYS)
    for k in ("workload", "measured_train_step", "coverage_curve_exact"):
        assert set(art[k]) == set(committed[k]), k
