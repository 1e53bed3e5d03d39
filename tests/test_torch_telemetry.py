"""Port: the telemetry layer against the JAX package, on the CPU.

* ``SCHEMAS`` and ``ENVELOPE_FIELDS`` are the JAX package's and
  tools/analysis/formats.lock.json's ``telemetry_schemas``.
* The port's ``train`` (the CLI, in a fresh process) and the JAX ``train``
  on one config and one shared npz, both with ``metrics_path``, emit the
  same kinds, each record with the JAX record's keys, at the same steps,
  with train losses within the tolerance of tests/test_torch_training.py
  (atol 1e-5); tools/report.py renders the port's run and ``--compare``
  holds it against the JAX run.
* The JAX tests of tests/test_telemetry.py where the port has a
  counterpart: every kind carries the envelope and its keys, an unknown
  kind raises, the anomaly record names the first non-finite tensor, the
  compile sentinel counts builds and captures, the watchdog (one record
  per episode, suspended phases, a frozen ``step_hook`` fires it once with
  stacks and a classification, quiet across validation), the stall
  classifier, steady-state compiles only after the first epoch, a diverged
  run's anomaly record in strict JSON, the report.
* ``MetricsLogger(`` is constructed only in telemetry.py and
  utils/tracing.py of the port (tools/analysis/check_telemetry.py's rule).
* ``telemetry`` imports without torch and initialises no CUDA.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_tffm_tpu import telemetry as jax_telemetry
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch import telemetry
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.telemetry import (
    ENVELOPE_FIELDS,
    SCHEMAS,
    CompileSentinel,
    RunMonitor,
    classify_stall,
    compiling_now,
    device_live_bytes,
    note_cache_hit,
    note_compile,
    thread_stacks,
)
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20


def quiet(*_):
    pass


def _read(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _kinds(records, kind):
    return [r for r in records if r["kind"] == kind]


def _assert_schema(records):
    for r in records:
        assert all(f in r for f in ENVELOPE_FIELDS), r
        assert all(k in r for k in SCHEMAS[r["kind"]]), r


def _steady(records):
    return [r for r in _kinds(records, "compile") if not r["warmup"]]


# --- the schema ------------------------------------------------------------------


def test_schemas_equal_the_jax_package_and_the_lock_file():
    assert SCHEMAS == jax_telemetry.SCHEMAS
    assert ENVELOPE_FIELDS == jax_telemetry.ENVELOPE_FIELDS
    assert telemetry.SCHEMA_VERSION == jax_telemetry.SCHEMA_VERSION
    with open(os.path.join(REPO, "tools", "analysis", "formats.lock.json")) as f:
        lock = json.load(f)["sections"]["telemetry_schemas"]
    assert list(ENVELOPE_FIELDS) == lock["ENVELOPE_FIELDS"]
    assert {k: sorted(v) for k, v in SCHEMAS.items()} == lock["SCHEMAS"]


_PAYLOADS = {
    "train": dict(epoch=0, loss=0.69, examples_per_sec=1000.0, examples_per_sec_per_chip=1000.0),
    "validation": dict(epoch=0, validation_auc=0.75),
    "input": dict(input_items=4, input_steps=4, input_examples=128, parse_ms=0.2),
    "predict": dict(examples=100, examples_per_sec=5000.0),
    "serving": dict(requests=10, flushes=3, rows=10, queue_ms={}, compute_ms={}, total_ms={}),
    "ckpt": dict(mode="full", snapshot_ms=1.0, convert_ms=2.0, d2h_ms=3.0, write_ms=4.0,
                 bytes=1024, rows_written=7, train_stall_ms=1.0),
    "fault": dict(event="crash"),
    "restart": dict(attempt=1, exit_code=-9, backoff_s=0.5, mttr_s=2.1),
    "profile": dict(program="train_step", flops=None, bytes_accessed=None),
    "datastats": dict(window_steps=3, ids=256, unique=147, dedup_ratio=0.5742, rows_seen=147,
                      hh_k=16, hh_topk_mass=0.23),
    "freshness": dict(publish_step=12, publish_to_applied_ms=41.2,
                      publish_to_first_scored_ms=44.8),
    "quality": dict(hour=3, auc_online=0.83, auc_batch=0.82),
    "soak": dict(phase="steady", elapsed_s=61.2, ok=True),
    "tiering": dict(hit_rate=0.6, miss_rows=812, miss_bytes_per_step=58464, writeback_rows=812,
                    writeback_ms=1.9, resolve_ms=3.2, restages=0, pending_rows=812),
}


def test_every_kind_carries_envelope_and_required_keys(tmp_path):
    """Each kind once (organically where the monitor owns the emitter):
    every record carries the envelope and its kind's keys."""
    from fast_tffm_tpu_torch.trainer import TrainState
    import torch

    path = str(tmp_path / "m.jsonl")
    mon = RunMonitor(path, source="train", stall_timeout_s=0.15, mem_every_s=0.01,
                     queue_depth_fn=lambda: 2)
    for kind, payload in _PAYLOADS.items():
        mon.emit(kind, step=1, **payload)
    note_compile()  # a build or a capture
    mon.on_dispatch(2, warmup=False)
    mon.emit_mem(step=2)
    state = TrainState(table=torch.tensor([[np.nan]]), dense=[], step=3)
    mon.emit_anomaly(3, float("nan"), state=state)
    time.sleep(0.5)  # the stall: the heartbeat frozen past the deadline
    mon.close()
    records = _read(path)
    assert {r["kind"] for r in records} == set(SCHEMAS)
    assert len({r["run_id"] for r in records}) == 1
    _assert_schema(records)
    assert all(r["schema_version"] == 1 for r in records)
    ts = [r["t"] for r in records]
    assert ts == sorted(ts)


def test_unknown_kind_raises(tmp_path):
    mon = RunMonitor(str(tmp_path / "m.jsonl"))
    with pytest.raises(ValueError, match="unknown telemetry kind"):
        mon.emit("nope", step=0)
    jmon = jax_telemetry.RunMonitor(str(tmp_path / "j.jsonl"))
    with pytest.raises(ValueError) as je:
        jmon.emit("nope", step=0)
    with pytest.raises(ValueError) as e:
        mon.emit("nope", step=0)
    assert str(e.value) == str(je.value)
    mon.close()
    jmon.close()


def test_anomaly_names_first_nonfinite_tensor(tmp_path):
    import torch

    from fast_tffm_tpu_torch.trainer import TrainState

    path = str(tmp_path / "m.jsonl")
    mon = RunMonitor(path)
    state = TrainState(table=torch.ones(3, 2), dense=[], step=0,
                       table_accum=torch.tensor([[1.0, float("inf")]]))
    mon.emit_anomaly(7, float("nan"), state=state)
    mon.close()
    (rec,) = _kinds(_read(path), "anomaly")
    assert rec["step"] == 7 and rec["first_nonfinite"] == "table_accum"
    assert rec["loss"] == "nan"  # strict JSON: the string name


def test_compile_sentinel_counts_builds_captures_and_cache_hits():
    s = CompileSentinel()
    assert s.drain() == 0 and s.drain_cache_hits() == 0
    note_compile()
    note_compile()
    note_cache_hit()
    assert s.drain() == 2 and s.drain_cache_hits() == 1
    assert s.drain() == 0


def test_kernel_build_feeds_the_sentinel(tmp_path, monkeypatch):
    """A host library built by g++ is one compile, loading it again from
    the build directory a cache hit (each counted by kernel_build)."""
    from fast_tffm_tpu_torch.ops import kernel_build

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(kernel_build, "_libs", {})
    s = CompileSentinel()
    kernel_build.load_host("libsvm_parser")
    assert s.drain() == 1 and s.drain_cache_hits() == 0
    monkeypatch.setattr(kernel_build, "_libs", {})
    kernel_build.load_host("libsvm_parser")
    assert s.drain() == 0 and s.drain_cache_hits() == 1


def test_device_live_bytes_is_none_on_the_cpu():
    import torch

    assert device_live_bytes(None) is None
    assert device_live_bytes(torch.device("cpu")) is None


def test_telemetry_imports_without_torch_and_initialises_no_cuda():
    code = (
        "import sys\n"
        "import fast_tffm_tpu_torch.telemetry as t\n"
        "assert 'torch' not in sys.modules, 'telemetry dragged in torch'\n"
        "assert 'jax' not in sys.modules\n"
        "t.arm_hang_exit(60, 'x').cancel()\n"
        "import torch, fast_tffm_tpu_torch.training\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_metrics_logger_is_constructed_only_in_the_telemetry_layer():
    """tools/analysis/check_telemetry.py's rule 1, on the port's tree."""
    pkg = os.path.join(REPO, "fast_tffm_tpu_torch")
    allowed = {"telemetry.py", os.path.join("utils", "tracing.py")}
    found = set()
    for root, _dirs, files in os.walk(pkg):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            for node in ast.walk(ast.parse(open(path).read())):
                if (isinstance(node, ast.Call) and getattr(node.func, "id",
                                                           getattr(node.func, "attr", None))
                        == "MetricsLogger"):
                    found.add(os.path.relpath(path, pkg))
                # Rule 3: every literal kind passed to .emit is registered.
                if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "emit"
                        and node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    assert node.args[0].value in SCHEMAS, (path, node.args[0].value)
    assert found and found <= allowed, found


# --- the watchdog ------------------------------------------------------------------


def test_watchdog_fires_once_per_episode_with_stacks_and_depth(tmp_path):
    path = str(tmp_path / "m.jsonl")
    mon = RunMonitor(path, stall_timeout_s=0.15, queue_depth_fn=lambda: 3, log=quiet)
    mon.heartbeat(5)
    time.sleep(0.5)  # episode 1: one record despite several polls
    mon.heartbeat(6)  # recovered
    time.sleep(0.5)  # episode 2
    mon.close()
    stalls = _kinds(_read(path), "stall")
    assert [s["step"] for s in stalls] == [5, 6]
    first = stalls[0]
    assert first["deadline_s"] == 0.15 and first["since_last_step_s"] >= 0.15
    assert first["prefetch_queue_depth"] == 3
    assert first["classification"] == "device-bound"  # data was queued
    assert any("sleep" in s for s in first["stacks"].values())
    assert "telemetry-watchdog" not in first["stacks"]


def test_watchdog_suspended_during_no_dispatch_phases(tmp_path):
    path = str(tmp_path / "m.jsonl")
    mon = RunMonitor(path, stall_timeout_s=0.15, log=quiet)
    mon.heartbeat(3)
    with mon.suspended():
        time.sleep(0.5)
    time.sleep(0.1)
    mon.heartbeat(4)
    time.sleep(0.5)
    mon.close()
    stalls = _kinds(_read(path), "stall")
    assert len(stalls) == 1 and stalls[0]["step"] == 4


@pytest.mark.parametrize(
    "depth,stacks,alive",
    [
        (0, {}, None),
        (0, {}, False),
        (4, {"MainThread": "x"}, None),
        (None, {"MainThread": "  File \"x.py\", line 3, in f\n    torch.cuda.synchronize()\n"},
         None),
        (None, {"MainThread": "    cap.graph.replay()\n"}, None),
        (None, {"MainThread": "plain python"}, None),
    ],
)
def test_classify_stall_matches_jax_on_its_cases(depth, stacks, alive):
    """The JAX classifier's rule; the device markers are the port's own
    waits (a synchronize, a graph replay)."""
    got = classify_stall(depth, stacks, alive)
    if "synchronize" in str(stacks) or "replay" in str(stacks):
        assert got == "device-bound"
    else:
        assert got == jax_telemetry.classify_stall(depth, stacks, alive)
    assert "MainThread" in thread_stacks()


def test_watchdog_defers_while_building_or_capturing():
    assert compiling_now({"MainThread": '  File "/x/ops/kernel_build.py", line 9, in build\n'})
    assert compiling_now({"MainThread": '  File "/x/utils/step_graph.py", line 9, in _capture\n'})
    assert not compiling_now({"MainThread": "... in time.sleep\n"})


# --- instrumented runs ----------------------------------------------------------------


def _kw(tmp_path, name, **kw):
    for src in (TRAIN, TEST):
        if not (tmp_path / os.path.basename(src)).exists():
            shutil.copy(src, tmp_path)
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        validation_files=(str(tmp_path / "test.libsvm"),), epoch_num=2, batch_size=B,
        learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=5, thread_num=2,
        metrics_path=str(tmp_path / (name + ".jsonl")),
    )
    base.update(kw)
    return base


def _shared_npz(path):
    jcfg = JaxConfig(model="fm", order=3, factor_num=K, vocabulary_size=V).validate()
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, "element")
    table = np.random.default_rng(0).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _write_cfg(path, kw):
    """An INI file of the settings both packages read."""
    lines = ["[General]", "model = fm", f"order = {kw['order']}",
             f"factor_num = {kw['factor_num']}", f"vocabulary_size = {kw['vocabulary_size']}",
             f"model_file = {kw['model_file']}", "[Train]",
             f"train_files = {kw['train_files'][0]}",
             f"validation_files = {kw['validation_files'][0]}",
             f"epoch_num = {kw['epoch_num']}", f"batch_size = {kw['batch_size']}",
             f"max_nnz = {kw['max_nnz']}", f"learning_rate = {kw['learning_rate']}",
             f"factor_lambda = {kw['factor_lambda']}", f"bias_lambda = {kw['bias_lambda']}",
             f"log_every = {kw['log_every']}", f"thread_num = {kw['thread_num']}",
             f"metrics_path = {kw['metrics_path']}", "[Telemetry]", "mem_every_s = 0.001"]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The JAX trainer in this process and the port's CLI in a fresh one,
    on one config, from one shared npz."""
    tmp = tmp_path_factory.mktemp("both")
    _shared_npz(tmp / "init.ckpt")
    jkw, pkw = _kw(tmp, "jax.ckpt"), _kw(tmp, "port.ckpt")
    for kw in (jkw, pkw):
        shutil.copy(tmp / "init.ckpt", kw["model_file"])
    jax_train(JaxConfig(**jkw, telemetry_mem_every_s=0.001).validate(), resume=True,
              log=quiet)
    _write_cfg(tmp / "port.cfg", pkw)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train",
                        str(tmp / "port.cfg"), "--device", "cpu", "--resume", "--run-id",
                        "port-run"], capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=env)
    assert r.returncode == 0, r.stderr
    return _read(jkw["metrics_path"]), _read(pkw["metrics_path"]), jkw, pkw


def test_port_and_jax_runs_emit_the_same_kinds_keys_and_steps(both_runs):
    jrec, prec, _, _ = both_runs
    _assert_schema(prec)
    assert {r["kind"] for r in prec} == {r["kind"] for r in jrec} == {
        "train", "input", "validation", "ckpt", "profile", "compile", "mem", "summary"}
    assert {r["run_id"] for r in prec} == {"port-run"}
    for kind in {r["kind"] for r in jrec}:
        jkeys = set().union(*(r.keys() for r in _kinds(jrec, kind)))
        pkeys = set().union(*(r.keys() for r in _kinds(prec, kind)))
        if kind == "summary":
            # JAX adds its measured bytes per example; the port measures none.
            jkeys.discard("profile_train_bytes_per_example")
        assert jkeys <= pkeys, (kind, jkeys - pkeys)
    for kind in ("train", "validation", "ckpt", "summary"):
        assert [r["step"] for r in _kinds(prec, kind)] == [r["step"] for r in _kinds(jrec, kind)]
    # kind=input is drained at log points, and a drain that finds nothing
    # (the producer ran ahead into the last one) writes no record: which
    # log points carry one depends on the producer's pace, in both
    # packages.  Their totals do not.
    train_steps = {r["step"] for r in _kinds(jrec, "train")} | {20, 40}
    for recs in (prec, jrec):
        assert {r["step"] for r in _kinds(recs, "input")} <= train_steps
    for key in ("input_items", "input_steps", "input_examples"):
        assert sum(r[key] for r in _kinds(prec, "input")) == sum(
            r[key] for r in _kinds(jrec, "input")) > 0
    assert [r["program"] for r in _kinds(prec, "profile")] == ["train_step"]
    np.testing.assert_allclose([r["loss"] for r in _kinds(prec, "train")],
                               [r["loss"] for r in _kinds(jrec, "train")], atol=1e-5)
    (summary,) = _kinds(prec, "summary")
    assert summary["steady_compiles"] == 0 and summary["stalls"] == 0
    assert _steady(prec) == []
    assert all(r["examples_per_sec"] is None or r["examples_per_sec"] > 0
               for r in _kinds(prec, "train"))


def test_report_renders_a_port_run_and_compares_it_with_the_jax_run(both_runs):
    """CPU rates measure neither package, so the compare runs at a
    threshold only a run without train rates fails: what it checks is that
    the gate reads both streams alike."""
    _, _, jkw, pkw = both_runs
    tool = os.path.join(REPO, "tools", "report.py")
    r = subprocess.run([sys.executable, tool, pkw["metrics_path"]], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for needle in ("Throughput", "Loss", "Events", "steady-state", "Memory"):
        assert needle in r.stdout, f"{needle} missing from the report:\n{r.stdout}"
    r = subprocess.run([sys.executable, tool, pkw["metrics_path"], "--compare",
                        jkw["metrics_path"], "--threshold", "0.99"], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _cfg(tmp_path, name="m.ckpt", **kw):
    return Config(**_kw(tmp_path, name, **kw)).validate()


def test_streamed_train_telemetry_schema_and_zero_steady_compiles(tmp_path):
    cfg = _cfg(tmp_path, telemetry_stall_timeout_s=30.0, telemetry_mem_every_s=0.001,
               validation_files=())
    train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    assert {"train", "input", "mem", "summary", "profile"} <= {r["kind"] for r in records}
    assert len({r["run_id"] for r in records}) == 1
    _assert_schema(records)
    assert _steady(records) == []
    (summary,) = _kinds(records, "summary")
    assert summary["steady_compiles"] == 0 and summary["stalls"] == 0
    assert summary["anomalies"] == 0
    assert all(r["device_bytes"] is None for r in _kinds(records, "mem"))  # the CPU


def test_compiles_are_warmup_in_the_first_epoch_and_steady_after(tmp_path):
    """A build or capture in the first epoch this process runs (the K-step
    epoch tail's capture lands there) is warm-up; one in a later epoch is
    a steady-state recompile, on the record and in the summary."""
    cfg = _cfg(tmp_path, validation_files=())

    def hook(step):
        if step in (7, 27):  # epoch 0 and epoch 1
            note_compile()

    train(cfg, log=quiet, device="cpu", step_hook=hook)
    records = _read(cfg.metrics_path)
    compiles = [r for r in _kinds(records, "compile") if r["compiles"]]
    assert [(r["step"], r["warmup"]) for r in compiles] == [(8, True), (28, False)]
    (summary,) = _kinds(records, "summary")
    assert summary["steady_compiles"] == 1


def test_watchdog_fires_on_frozen_step_hook(tmp_path):
    cfg = _cfg(tmp_path, telemetry_stall_timeout_s=0.5, validation_files=())
    frozen = []

    def hook(step):
        if not frozen and step >= 8:
            frozen.append(step)
            time.sleep(1.5)

    train(cfg, log=quiet, device="cpu", step_hook=hook)
    records = _read(cfg.metrics_path)
    (s,) = _kinds(records, "stall")
    assert s["step"] == frozen[0] and s["since_last_step_s"] >= 0.5
    assert s["classification"] in ("input-starved", "device-bound", "unknown")
    assert s["prefetch_queue_depth"] is not None  # streamed input: the live depth
    assert any("hook" in v or "sleep" in v for v in s["stacks"].values())
    (summary,) = _kinds(records, "summary")
    assert summary["stalls"] == 1


def test_watchdog_quiet_across_validation_epoch_boundary(tmp_path, monkeypatch):
    """A validation pass longer than the deadline (one second here) runs
    under suspended(): no stall record."""
    from fast_tffm_tpu_torch import training

    real = training._evaluate

    def slow(*a, **kw):
        time.sleep(1.0)
        return real(*a, **kw)

    monkeypatch.setattr(training, "_evaluate", slow)
    cfg = _cfg(tmp_path, telemetry_stall_timeout_s=0.5)
    train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    assert _kinds(records, "stall") == []
    assert len(_kinds(records, "validation")) == 2
    assert _steady(records) == []


def test_nan_divergence_emits_anomaly_record(tmp_path):
    cfg = _cfg(tmp_path, learning_rate=float("inf"), epoch_num=1, validation_files=())
    with pytest.raises(RuntimeError, match="loss is"):
        train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    anomalies = _kinds(records, "anomaly")
    assert anomalies and anomalies[0]["event"] == "nonfinite_loss"
    assert not np.isfinite(float(anomalies[0]["loss"]))
    assert "table" in anomalies[0]["first_nonfinite"]

    def strict(const):
        raise ValueError(f"bare {const} token in JSONL")

    for line in open(cfg.metrics_path):
        json.loads(line, parse_constant=strict)
    (summary,) = _kinds(records, "summary")
    assert summary["anomalies"] >= 1


def test_enable_compilation_cache_logs_a_note():
    log = []
    assert telemetry.enable_compilation_cache("/nowhere/cc", log.append) is False
    assert len(log) == 1 and "compilation_cache_dir" in log[0] and "_build" in log[0]
