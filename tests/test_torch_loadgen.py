"""Port: tools/torch_loadgen.py against the JAX package's tools/loadgen.py.

* The helpers, bitwise for the same seed: ``synth_lines``' strings,
  ``parse_class_mix``, the ``draw_class`` sequence and
  ``build_frame_pool``'s request-frame bytes (classes and deadlines).
* The counterpart of tests/test_serving.py's loadgen smoke: a closed loop
  in process on the CPU with mixed request sizes, zero steady-state
  recompiles, a well-formed BENCH_SERVE object with the JAX keys; the open
  loop in process forces ``serve_overload = reject`` and says so.
* The socket tier: ``--spawn`` (``cli serve --port 0 --device cpu`` with 2
  replicas) driven open-loop over binary frames, over JSONL and with two
  sender processes, every request answered; ``--stats``; ``--probe-freshness
  2`` (publishes through the port's checkpoint writer; every trial flips).
* tools/report.py reads the port's BENCH_SERVE artifact and renders it.
* Without a card and without ``--device cpu`` it exits non-zero.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import loadgen  # noqa: E402
import report  # noqa: E402
import torch_loadgen  # noqa: E402

SCRIPT = os.path.join(REPO, "tools", "torch_loadgen.py")
V, NNZ = 128, 6

# The JAX BENCH_SERVE keys of each transport (tools/loadgen.py's result).
COMMON_KEYS = {"bench", "mode", "qps_target", "concurrency", "class_mix", "deadline_ms",
               "flush_deadline_ms", "run_id", "schema_version", "transport", "warmup_s",
               "steady_state_recompiles", "duration_s", "requests_sent", "requests_scored",
               "qps_achieved", "client_ms", "client_ms_by_class", "shed_codes"}
INPROCESS_KEYS = {"buckets", "overload", "compile_count_warm", "compile_count_end",
                  "batch_occupancy"}
SOCKET_KEYS = {"unanswered", "wire", "freshness", "connections", "server", "engines"}


def _write_cfg(tmp_path, replicas=2, reload_s=0.0):
    path = tmp_path / "serve.cfg"
    path.write_text(f"""
[General]
model = fm
factor_num = 4
vocabulary_size = {V}
model_file = {tmp_path}/m.ckpt

[Train]
max_nnz = {NNZ}

[Serving]
buckets = 1 4 16
flush_deadline_ms = 2
replicas = {replicas}
reload_interval_s = {reload_s}
classes = gold:1 std:0
""")
    return str(path)


def _run(args, timeout=240, check=True):
    proc = subprocess.run([sys.executable, SCRIPT, *args], capture_output=True, text=True,
                          cwd=REPO, timeout=timeout)
    if check:
        assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.mark.parametrize("seed,max_nnz", [(0, 6), (3, 11), (7, 1)])
def test_synth_lines_bitwise(seed, max_nnz):
    cfg = types.SimpleNamespace(vocabulary_size=V)
    assert torch_loadgen.synth_lines(cfg, 300, max_nnz, seed) == \
        loadgen.synth_lines(cfg, 300, max_nnz, seed)


@pytest.mark.parametrize("spec", ["gold:0.1,std:0.9", "a:1,b:1,c:2", "solo:3"])
def test_class_mix_and_draws_bitwise(spec):
    mix = torch_loadgen.parse_class_mix(spec)
    assert mix == loadgen.parse_class_mix(spec)
    ra, rb = np.random.default_rng(5), np.random.default_rng(5)
    assert [torch_loadgen.draw_class(ra, mix) for _ in range(500)] == \
        [loadgen.draw_class(rb, mix) for _ in range(500)]
    with pytest.raises(ValueError):
        torch_loadgen.parse_class_mix("gold")


@pytest.mark.parametrize("mix,deadline_ms", [(None, 0.0), ("gold:0.3,std:0.7", 50.0)])
def test_build_frame_pool_bytes(mix, deadline_ms):
    cfg = types.SimpleNamespace(vocabulary_size=V, hash_feature_id=False, max_nnz=NNZ)
    lines = loadgen.synth_lines(cfg, 200, NNZ, 1)
    parsed = torch_loadgen.parse_class_mix(mix) if mix else None
    got = torch_loadgen.build_frame_pool(lines, cfg, parsed, 16, 4, False, deadline_ms,
                                         n_templates=24)
    want = loadgen.build_frame_pool(lines, cfg, parsed, 16, 4, False, deadline_ms,
                                    n_templates=24)
    assert got == want


def test_loadgen_smoke_zero_recompiles(tmp_path):
    """The port's counterpart of tests/test_serving.py::test_loadgen_smoke_zero_recompiles."""
    cfg = _write_cfg(tmp_path, replicas=1)
    out = tmp_path / "bench_serve.json"
    proc = _run([cfg, "--mode", "closed", "--concurrency", "4", "--duration", "1.0",
                 "--device", "cpu", "--init-missing-checkpoint", "--out", str(out)])
    result = json.loads(proc.stdout)
    assert result["bench"] == "BENCH_SERVE"
    assert result["steady_state_recompiles"] == 0
    assert result["requests_scored"] > 0
    assert result["client_ms"]["p99"] > 0
    assert 0 < result["batch_occupancy"] <= 1
    assert COMMON_KEYS | INPROCESS_KEYS <= set(result)
    assert result["device"] == "cpu" and result["card"] is None
    assert "torch_version" in result and "kernel_launches" in result
    # tools/report.py reads the artifact and renders its section.
    loaded = report.load_bench_serve(str(out))
    assert "Serving bench" in report.render_bench_serve(loaded)


def test_open_loop_in_process_forces_reject(tmp_path):
    cfg = _write_cfg(tmp_path, replicas=1)
    proc = _run([cfg, "--qps", "300", "--duration", "0.5", "--device", "cpu",
                 "--classes", "gold:0.5,std:0.5", "--deadline-ms", "500",
                 "--init-missing-checkpoint"])
    result = json.loads(proc.stdout)
    assert "forces serve_overload = reject" in proc.stderr
    assert result["overload"] == "reject" and result["mode"] == "open"
    assert result["qps_target"] == 300.0 and result["requests_scored"] > 0
    assert set(result["client_ms_by_class"]) <= {"gold", "std"}


@pytest.mark.parametrize("wire,extra", [("binary", ["--frame-rows", "8"]), ("jsonl", []),
                                        ("binary", ["--processes", "2"])])
def test_socket_open_loop_two_replicas(tmp_path, wire, extra):
    cfg = _write_cfg(tmp_path)
    proc = _run([cfg, "--spawn", "--device", "cpu", "--init-missing-checkpoint", "--qps", "200",
                 "--duration", "1.0", "--connections", "2", "--wire", wire, *extra])
    result = json.loads(proc.stdout)
    assert result["transport"] == "socket" and result["wire"] == wire
    assert result["unanswered"] == 0
    assert result["requests_scored"] == result["requests_sent"] > 0
    assert result["steady_state_recompiles"] == 0
    assert len(result["server"]["replicas"]) == 2
    assert COMMON_KEYS | SOCKET_KEYS <= set(result)
    if "--processes" in extra:
        assert result["processes"] == 2


def test_stats_and_freshness_probe(tmp_path):
    cfg = _write_cfg(tmp_path, reload_s=0.2)
    stats = json.loads(_run([cfg, "--spawn", "--stats", "--device", "cpu",
                             "--init-missing-checkpoint"]).stdout)
    assert stats["op"] == "stats" and len(stats["replicas"]) == 2
    out = tmp_path / "fresh.json"
    proc = _run([cfg, "--spawn", "--probe-freshness", "2", "--device", "cpu", "--out", str(out)])
    probe = json.loads(proc.stdout)
    assert probe["probe"] == "PROBE_FRESHNESS" and probe["unanswered"] == 0
    assert probe["publish_to_first_scored_ms"]["count"] == 2
    assert probe["steady_state_recompiles"] == 0
    assert json.loads(out.read_text())["trials"] == 2


def test_needs_a_card_or_device_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    cfg = _write_cfg(tmp_path, replicas=1)
    proc = _run([cfg, "--mode", "closed", "--duration", "0.2", "--init-missing-checkpoint"],
                check=False)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
