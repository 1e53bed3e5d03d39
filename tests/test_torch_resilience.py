"""Port: fault-tolerant training against the JAX package, on the CPU
(tests/test_resilience.py's cases).

* The fault grammar: ``FAULT_KINDS``, ``SERVING_FAULT_KINDS`` and
  ``STREAM_FAULT_KINDS`` equal the JAX tuples; ``FaultPlan.to_json`` is
  byte-identical to the JAX output over explicit and seeded specs that use
  every kind, and the parse errors are the same.
* ``FaultInjector``: every fault fires once (kill, nan windows, IO ops,
  torn deltas, publish kills, writeback applies); the events and counters
  drain as in the JAX package.
* ``repair_delta_chain`` on a chain the JAX package wrote, with a torn tail
  and with a bad link, quarantines the files the JAX function does.
* An injected ``io_error`` is absorbed by the FMB reader's retry: no row
  lost or repeated, the training run bitwise the clean run.
* ``on_nan = rollback``: the port's ``train`` and the JAX ``train`` with
  the same plan from one shared npz (K = 1 and K = 4, streamed; a delta
  chain head) restore the same step and skip to the same cursor, and end
  with tables and accumulators within atol 1e-5 (the tolerance of
  tests/test_torch_training.py); the device cache at K = 4 restores into
  the live tensors; an exhausted budget raises; ``abort`` keeps the last
  good state.
* ``Supervisor``: restarts a fake child until it succeeds, with crash and
  restart records (MTTR) and exponential backoff; gives up after
  ``restart_max``; pod mode needs a ``runtime_dir`` (its runs are in
  tests/test_torch_pod.py).  A real ``cli train --supervised
  --device cpu`` under ``kill@N`` (alone, with ``torn_delta``, and
  ``kill_publish``) ends bitwise equal to the uninterrupted run.
* ``resilience`` and the supervising CLI import no torch.
"""

import dataclasses
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu import resilience as jax_resilience
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.checkpoint import save_delta as jax_save_delta
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch import resilience
from fast_tffm_tpu_torch import training
from fast_tffm_tpu_torch.checkpoint import latest_step, restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model, load_config
from fast_tffm_tpu_torch.data.binary import fmb_batch_stream, write_fmb
from fast_tffm_tpu_torch.resilience import (
    FaultPlan,
    NonFiniteLossError,
    Supervisor,
    install_faults,
    repair_delta_chain,
)
from fast_tffm_tpu_torch.trainer import unpack_state
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
V, K, NNZ, B = 256, 8, 8, 20
CPU = torch.device("cpu")


def quiet(*_):
    pass


@pytest.fixture(autouse=True)
def _clean_fault_state():
    """Fault plans and the event sinks are process-global, in both packages."""
    for mod in (resilience, jax_resilience):
        mod.clear_faults()
        mod.drain_fault_events()
        mod.drain_fault_counters()
    yield
    for mod in (resilience, jax_resilience):
        mod.clear_faults()
        mod.drain_fault_events()
        mod.drain_fault_counters()


def _records(path, kind=None):
    return [r for r in map(json.loads, open(path)) if kind is None or r.get("kind") == kind]


# --- the grammar ----------------------------------------------------------------


def test_fault_kind_tuples_are_the_jax_tuples():
    assert resilience.FAULT_KINDS == jax_resilience.FAULT_KINDS
    assert resilience.SERVING_FAULT_KINDS == jax_resilience.SERVING_FAULT_KINDS
    assert resilience.STREAM_FAULT_KINDS == jax_resilience.STREAM_FAULT_KINDS
    assert resilience.NonFiniteLossError is training.NonFiniteLossError


EVERY_KIND = ",".join(f"{k}=2" for k in jax_resilience.FAULT_KINDS)
SPECS = [
    ("kill@120,io_error@45,nan@200:210,torn_delta@1", 0, 1000),
    ("kill_publish@2, replica_kill@0,replica_slow@1:250,reload_corrupt@3,"
     "stream_stall@4,append_torn@2,kill_writeback@5,nan@7", 0, 1000),
    ("random:kill=2,io_error=3,nan=1", 7, 1000),
    ("random:kill=2,io_error=3,nan=1", 8, 400),
    (f"random:{EVERY_KIND}", 11, 1000),
    (f"random:{EVERY_KIND}", 12, 60),
    ("random:stream_stall=1,append_torn=2,", 5, 1000),
]


@pytest.mark.parametrize("spec,seed,horizon", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_fault_plan_json_is_byte_identical_to_jax(spec, seed, horizon):
    got = FaultPlan.parse(spec, seed=seed, horizon=horizon)
    want = jax_resilience.FaultPlan.parse(spec, seed=seed, horizon=horizon)
    assert got.to_json() == want.to_json()
    assert got.serving_events() == want.serving_events()
    assert got.stream_events() == want.stream_events()
    assert FaultPlan.parse(spec, seed=seed, horizon=horizon).to_json() == got.to_json()


@pytest.mark.parametrize("spec", ["explode@3", "kill@3:9", "nan@210:200", "  ", "kill",
                                  "replica_slow@1", "replica_slow@1:0", "random:boom=1",
                                  "stream_stall@0", "kill@0"])
def test_fault_plan_parse_errors_are_the_jax_errors(spec):
    with pytest.raises(ValueError) as mine:
        FaultPlan.parse(spec)
    with pytest.raises(ValueError) as theirs:
        jax_resilience.FaultPlan.parse(spec)
    assert str(mine.value) == str(theirs.value)


# --- the injector -----------------------------------------------------------------


def test_every_fault_fires_once(tmp_path, monkeypatch):
    kills = []
    monkeypatch.setattr(resilience.os, "kill", lambda pid, sig: kills.append(sig))
    inj = install_faults(FaultPlan.parse(
        "kill@5,nan@10:12,nan@20:21,io_error@2,torn_delta@1,kill_publish@2,kill_writeback@3"))
    assert resilience.active_faults() is inj
    inj.step_hook(4)
    inj.step_hook(8)  # the K-step grid passes 5: fires at the first hook >= it
    inj.step_hook(9)
    assert kills == [9]
    assert [inj.nan_due(s) for s in (9, 11, 11, 24)] == [False, True, False, False]
    resilience.maybe_io_fault("a")
    with pytest.raises(OSError, match="op #2"):
        resilience.maybe_io_fault("b")
    resilience.maybe_io_fault("c")
    f = tmp_path / "d.npz"
    f.write_bytes(b"x" * 90)
    resilience.maybe_torn_delta(str(f))
    assert f.stat().st_size == 30
    resilience.maybe_torn_delta(str(f))
    assert f.stat().st_size == 30
    for n in range(3):
        resilience.maybe_publish_fault(f"p{n}")
        resilience.maybe_writeback_fault(n + 2)
    assert kills == [9, 9, 9]  # publish 2 and writeback apply 3, each once
    counters = resilience.drain_fault_counters()
    assert counters == {"injected_nan": 1, "injected_io_error": 1, "injected_torn_delta": 1,
                        "injected_kill_publish": 1, "injected_kill_writeback": 1}
    events = resilience.drain_fault_events()
    assert [e["event"] for e in events] == ["injected_nan", "injected_io_error",
                                            "injected_torn_delta", "injected_kill_publish",
                                            "injected_kill_writeback"]
    assert events[0] == {"event": "injected_nan", "at": 11, "planned_at": 10}
    resilience.clear_faults()
    resilience.maybe_io_fault("d")  # disarmed: a no-op
    assert resilience.active_faults() is None


# --- the chain repair -------------------------------------------------------------


def _jax_chain(path, n_deltas=3):
    jcfg = JaxConfig(model="fm", factor_num=4, vocabulary_size=64).validate()
    model = jax_build_model(jcfg)
    jax_save_checkpoint(path, jax_init_state(model, jax.random.key(0)), save_id="base0")
    parent = "base0"
    for i in range(1, n_deltas + 1):
        _, parent, _ = jax_save_delta(
            path, i, idx=np.array([i]),
            table_rows=np.full((1, model.row_dim), float(i), np.float32),
            accum_rows=np.ones((1, model.row_dim), np.float32),
            dense_leaves=[], dense_accum_leaves=[], step=np.int32(i * 5), parent_sig=parent,
        )


@pytest.mark.parametrize("damage", ["torn-tail", "bad-link", "healthy", "no-base"])
def test_repair_quarantines_what_the_jax_repair_does(tmp_path, damage):
    paths = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        d.mkdir()
        path = str(d / "m.ckpt")
        _jax_chain(path)
        if damage == "torn-tail":
            with open(f"{path}.delta-0003.npz", "r+b") as f:
                f.truncate(os.path.getsize(f"{path}.delta-0003.npz") // 3)
        elif damage == "bad-link":
            with open(f"{path}.delta-0002.npz", "r+b") as f:
                f.truncate(100)
        elif damage == "no-base":
            os.remove(path)
        paths[who] = path
    logs, jlogs = [], []
    got = repair_delta_chain(paths["port"], log=logs.append)
    want = jax_resilience.repair_delta_chain(paths["jax"], log=jlogs.append)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert logs == jlogs
    assert len(got) == {"torn-tail": 1, "bad-link": 2, "healthy": 0, "no-base": 0}[damage]
    if damage in ("torn-tail", "bad-link"):
        assert latest_step(paths["port"]) == (10 if damage == "torn-tail" else 5)
        restored = restore_checkpoint(paths["port"], CPU, accum_width=5)
        assert restored.step == latest_step(paths["port"])
        assert resilience.drain_fault_counters() == {"chain_repair": 1}


# --- io_error ---------------------------------------------------------------------


def _fmb(tmp_path):
    return write_fmb(TRAIN, str(tmp_path / "t.fmb"), vocabulary_size=V)


def test_injected_io_errors_are_absorbed_with_no_row_lost_or_repeated(tmp_path):
    fmb = _fmb(tmp_path)

    def batches(**kw):
        return [(p.labels.copy(), p.ids.copy(), p.vals.copy(), p.nnz.copy(), w.copy())
                for p, w in fmb_batch_stream([fmb], batch_size=32, vocabulary_size=V,
                                             max_nnz=NNZ, **kw)]

    clean = batches()
    install_faults(FaultPlan.parse("io_error@3,io_error@5"))
    logs = []
    faulted = batches(io_retry_backoff_s=0.0, log=logs.append)
    assert len(faulted) == len(clean)
    for a, b in zip(clean, faulted):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert resilience.drain_fault_counters() == {"injected_io_error": 2, "io_retry": 2}
    assert len(logs) == 2 and all(m.startswith("io retry 1/3 on") for m in logs)
    resilience.drain_fault_events()
    install_faults(FaultPlan.parse("io_error@1,io_error@2,io_error@3"))
    with pytest.raises(OSError, match="injected transient IO fault"):
        list(fmb_batch_stream([fmb], batch_size=32, vocabulary_size=V, max_nnz=NNZ,
                              io_retries=2, io_retry_backoff_s=0.0))


def _shared_npz(path):
    """A seeded [V, 1+K] table with element accumulators at 0.1, saved by
    the JAX package without a cursor."""
    jcfg = JaxConfig(model="fm", order=3, factor_num=K, vocabulary_size=V).validate()
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1)
    table = np.random.default_rng(0).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _kw(tmp_path, name, **kw):
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(TRAIN,), epoch_num=2, batch_size=B,
        learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=4,
        metrics_path=str(tmp_path / (name + ".jsonl")),
    )
    base.update(kw)
    return base


def _port_run(tmp_path, init, name, plan=None, **kw):
    shutil.copy(init, tmp_path / name)
    cfg = Config(**_kw(tmp_path, name, **kw)).validate()
    hook = install_faults(FaultPlan.parse(plan)).step_hook if plan else None
    logs = []
    state = train(cfg, resume=True, device="cpu", log=logs.append, step_hook=hook)
    resilience.clear_faults()
    return cfg, state, logs


def test_an_io_error_in_training_is_absorbed_and_the_run_is_bitwise_the_clean_run(tmp_path):
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    fmb = _fmb(tmp_path)
    kw = dict(train_files=(fmb,), epoch_num=1, io_retry_backoff_s=0.0)
    _, clean, _ = _port_run(tmp_path, init, "clean.ckpt", **kw)
    cfg, faulted, logs = _port_run(tmp_path, init, "faulted.ckpt", "io_error@4", **kw)
    assert torch.equal(clean.table, faulted.table)
    assert torch.equal(clean.table_accum, faulted.table_accum)
    faults = {r["event"] for r in _records(cfg.metrics_path, "fault")}
    assert {"injected_io_error", "io_retry"} <= faults
    (summary,) = _records(cfg.metrics_path, "summary")
    assert summary["fault_io_retry"] == 1 and summary["fault_injected_io_error"] == 1


# --- on_nan = rollback ------------------------------------------------------------


def _rollback_records(path):
    return [{k: r[k] for k in ("step", "rollback_n", "restored_step", "skip_to_epoch",
                               "skip_to_batch")}
            for r in _records(path, "anomaly") if r["event"] == "rollback"]


ROLLBACKS = [
    # Detected at the log point after step 30 (K = 1) or 32 (K = 4's call):
    # step 32, cursor (1, 12); restored to the epoch-0 save at step 20.
    (dict(steps_per_call=1), "nan@30:33"),
    (dict(steps_per_call=4), "nan@30:33"),
    # A delta chain head: the deltas at 4 and 8 (log_every 1), nan at 6.
    (dict(delta_every_steps=4, log_every=1, epoch_num=1), "nan@6"),
    # The epoch-end check: no log point in the window (log_every past it).
    (dict(log_every=100), "nan@26"),
]


@pytest.mark.parametrize("kw,plan", ROLLBACKS, ids=["k1", "k4", "delta-head", "epoch-end"])
def test_rollback_restores_and_skips_as_jax_does(tmp_path, kw, plan):
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    kw = dict(kw, on_nan="rollback", save_every_epochs=1)
    cfg, state, logs = _port_run(tmp_path, init, "port.ckpt", plan, **kw)
    shutil.copy(init, tmp_path / "jax.ckpt")
    jcfg = JaxConfig(telemetry_profile_costs=False, **_kw(tmp_path, "jax.ckpt", **kw)).validate()
    inj = jax_resilience.install_faults(jax_resilience.FaultPlan.parse(plan))
    jlogs = []
    jstate = jax_train(jcfg, resume=True, log=jlogs.append, step_hook=inj.step_hook)
    got, want = _rollback_records(cfg.metrics_path), _rollback_records(jcfg.metrics_path)
    assert got == want and len(got) == 1
    assert state.step == int(jstate.step)
    line = [m.replace(cfg.model_file, "M") for m in logs if m.startswith("on_nan = rollback")]
    assert line == [m.replace(jcfg.model_file, "M") for m in jlogs
                    if m.startswith("on_nan = rollback")]
    with np.load(jcfg.model_file) as z:
        np.testing.assert_allclose(state.table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(state.table_accum.numpy(), z["table_accum"], atol=1e-5)
    events = [r["event"] for r in _records(cfg.metrics_path, "anomaly")]
    assert events == ["nonfinite_loss", "rollback"]
    assert "injected_nan" in {r["event"] for r in _records(cfg.metrics_path, "fault")}


def test_rollback_on_the_device_cache_restores_into_the_live_tensors(tmp_path, monkeypatch):
    """K = 4 on the device cache: the rollback copies the checkpoint into
    the state's tensors (the same storage the K-step call reads), and the
    run ends bitwise a run that resumes the same checkpoint at the skip
    cursor."""
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    fmb = _fmb(tmp_path)
    kw = dict(train_files=(fmb,), device_cache=True, steps_per_call=4, save_every_epochs=1)
    restores = []
    real = training._restore_into

    def spy(state, restored):
        restores.append((state.table.data_ptr(), state.table_accum.data_ptr()))
        real(state, restored)
        restores.append((state.table.data_ptr(), state.table_accum.data_ptr()))

    monkeypatch.setattr(training, "_restore_into", spy)
    cfg, state, _ = _port_run(tmp_path, init, "rb.ckpt", "nan@30:33", on_nan="rollback", **kw)
    assert len(restores) == 2 and restores[0] == restores[1]
    (rec,) = _rollback_records(cfg.metrics_path)
    assert (rec["restored_step"], rec["skip_to_epoch"], rec["skip_to_batch"]) == (20, 1, 12)
    # The reference: the epoch-0 checkpoint with the skip cursor, resumed.
    _, first, _ = _port_run(tmp_path, init, "ref.ckpt", **dict(kw, epoch_num=1))
    from fast_tffm_tpu_torch.checkpoint import read_input_cursor, save_checkpoint

    cursor = dict(read_input_cursor(str(tmp_path / "ref.ckpt")), epoch=1, batch_in_epoch=12)
    save_checkpoint(str(tmp_path / "ref.ckpt"), first, cursor=cursor)
    ref_cfg = Config(**_kw(tmp_path, "ref.ckpt", **kw)).validate()
    ref = train(ref_cfg, resume=True, device="cpu", log=quiet)
    assert ref.step == state.step == 28
    assert torch.equal(ref.table, state.table) and torch.equal(ref.table_accum, state.table_accum)


def test_an_exhausted_rollback_budget_raises(tmp_path):
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    with pytest.raises(NonFiniteLossError, match="loss is nan"):
        # The first window fires at 22 (rolled back at the log point 24 to the
        # epoch-0 save), the second at 26 of the run that skipped to (1, 4).
        _port_run(tmp_path, init, "m.ckpt", "nan@22:25,nan@26:29", on_nan="rollback",
                  max_rollbacks=1, save_every_epochs=1)
    resilience.clear_faults()
    with pytest.raises(NonFiniteLossError):
        _port_run(tmp_path, init, "z.ckpt", "nan@30:33", on_nan="rollback", max_rollbacks=0,
                  save_every_epochs=1)


def test_abort_raises_and_keeps_the_last_good_state(tmp_path):
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    with pytest.raises(NonFiniteLossError) as err:
        _port_run(tmp_path, init, "m.ckpt", "nan@6", delta_every_steps=4, log_every=1,
                  epoch_num=1)
    assert err.value.step == 6 and err.value.cursor["batch_in_epoch"] == 6
    assert latest_step(str(tmp_path / "m.ckpt")) == 4


def test_rollback_with_no_checkpoint_yet_raises(tmp_path):
    data = tmp_path / "t.libsvm"
    shutil.copy(TRAIN, data)
    cfg = Config(**_kw(tmp_path, "m.ckpt", train_files=(str(data),), on_nan="rollback",
                       epoch_num=1)).validate()
    install_faults(FaultPlan.parse("nan@6"))
    with pytest.raises(NonFiniteLossError):
        train(cfg, device="cpu", log=quiet)
    assert latest_step(cfg.model_file) is None


# --- the supervisor ---------------------------------------------------------------

_FLAKY_CHILD = textwrap.dedent(
    """
    import os, sys
    p = sys.argv[1]
    n = int(open(p).read()) if os.path.exists(p) else 0
    open(p, "w").write(str(n + 1))
    print("step %d epoch 0 loss 0.5 examples/sec 10" % (n * 10 + 1), file=sys.stderr,
          flush=True)
    if n < 2:
        os._exit(9)
    print("training done: steps 0->30, model -> m.ckpt", file=sys.stderr, flush=True)
    """
)


def test_supervisor_restarts_until_the_child_succeeds(tmp_path):
    """The child logs to stderr, as the port's trainer does: the supervisor
    reads it merged into stdout."""
    counter, metrics, cmds, lines = str(tmp_path / "n"), str(tmp_path / "sup.jsonl"), [], []

    def build_cmd(attempt, resume):
        cmds.append((attempt, resume))
        return [sys.executable, "-c", _FLAKY_CHILD, counter]

    sup = Supervisor(build_cmd, model_file=str(tmp_path / "m.ckpt"), max_restarts=5,
                     backoff_s=0.01, backoff_max_s=0.05, metrics_path=metrics, log=quiet,
                     child_log=lines.append)
    assert sup.run() == 0
    assert sup.restarts == 2 and cmds == [(0, False), (1, False), (2, False)]
    faults, restarts = _records(metrics, "fault"), _records(metrics, "restart")
    assert [(f["event"], f["exit_code"], f["attempt"]) for f in faults] == [
        ("crash", 9, 0), ("crash", 9, 1)]
    assert [r["attempt"] for r in restarts] == [1, 2]
    assert all(isinstance(r["mttr_s"], float) and r["mttr_s"] > 0 for r in restarts)
    assert restarts[1]["backoff_s"] > restarts[0]["backoff_s"]
    (summary,) = _records(metrics, "summary")
    assert summary["supervisor_restarts"] == 2 and summary["mttr_s_median"] > 0
    assert any(m.startswith("training done") for m in lines)


def test_supervisor_gives_up_after_restart_max(tmp_path):
    metrics = str(tmp_path / "sup.jsonl")
    sup = Supervisor(lambda attempt, resume: [sys.executable, "-c", "import os; os._exit(3)"],
                     model_file=str(tmp_path / "m.ckpt"), max_restarts=1, backoff_s=0.01,
                     metrics_path=metrics, log=quiet)
    assert sup.run() == 3 and sup.restarts == 1
    assert len(_records(metrics, "fault")) == 2 and len(_records(metrics, "restart")) == 1
    # Pod mode runs since the pod supervision was ported; it needs its runtime_dir.
    with pytest.raises(ValueError, match="requires runtime_dir"):
        Supervisor(lambda a, r: [], model_file="m", processes=2)


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "fast_tffm_tpu_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env, **kw)


def _ini(tmp_path, **train_keys) -> str:
    data = tmp_path / "t.libsvm"
    shutil.copy(TRAIN, data)
    keys = dict(train_files=str(data), max_nnz=NNZ, batch_size=B, epoch_num=2, log_every=2,
                learning_rate=0.05, metrics_path=str(tmp_path / "run.jsonl"))
    keys.update(train_keys)
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"[General]\nmodel = fm\norder = 3\nfactor_num = {K}\nvocabulary_size = {V}\n"
        f"model_file = {tmp_path / 'm.ckpt'}\n[Train]\n"
        + "".join(f"{k} = {v}\n" for k, v in keys.items())
        + "[Checkpoint]\ndelta_every_steps = 4\n[Resilience]\nrestart_backoff_s = 0.05\n"
    )
    return str(cfg)


@pytest.mark.parametrize("plan,quarantined", [("kill@10", 0), ("kill@14,torn_delta@1", 1),
                                              ("kill_publish@3", 0)])
def test_supervised_cli_survives_a_kill_and_ends_bitwise(tmp_path, plan, quarantined):
    """cli train --supervised: the child dies by SIGKILL (at step 10, after
    the base saved at 4 and the delta at 8; at 14, after torn_delta@1
    truncated the delta at 8, which the writer thread published before the
    boundary at 12 began; or between the tmp file and the rename of the
    third publish, at 12),
    the supervisor repairs the chain and relaunches with --resume, and the
    run ends bitwise the uninterrupted in-process run of the config."""
    ini = _ini(tmp_path)
    r = _cli(["train", ini, "--supervised", "--device", "cpu", "--fault-plan", plan])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "supervisor: trainer completed cleanly after 1 restart(s)" in r.stderr
    recs = _records(str(tmp_path / "run.jsonl"))
    assert len({x["run_id"] for x in recs}) == 1  # one run id, supervisor and children
    (crash,) = [x for x in recs if x["kind"] == "fault" and x["event"] == "crash"]
    assert crash["signal"] == 9 and crash["exit_code"] == -9
    (restart,) = [x for x in recs if x["kind"] == "restart"]
    assert restart["attempt"] == 1 and restart["mttr_s"] > 0
    # The repair runs in the supervising process, which logs it.
    repairs = re.findall(r"resilience: quarantined (\d+) delta file", r.stderr)
    # The torn delta and, when its writer had published it, the next.
    assert quarantined <= sum(map(int, repairs)) <= 2 * quarantined
    assert "fault plan armed" in r.stdout and r.stdout.count("fault plan armed") == 1
    cfg = load_config(ini)
    ref = dataclasses.replace(cfg, model_file=str(tmp_path / "ref.ckpt"), metrics_path="")
    want = train(ref, device="cpu", log=quiet)
    got = restore_checkpoint(cfg.model_file, CPU, accum_width=1 + K)
    assert got.step == want.step == 40
    assert torch.equal(got.table, want.table) and torch.equal(got.table_accum, want.table_accum)


def test_cli_refuses_fault_process_and_supervising_other_verbs(tmp_path):
    """--fault-process places a plan on one host of a pod; outside a pod the
    plan arms on this process, as the JAX CLI's does (kill@2: SIGKILL)."""
    ini = _ini(tmp_path)
    r = _cli(["train", ini, "--device", "cpu", "--fault-process", "1", "--fault-plan", "kill@2"])
    assert r.returncode == -signal.SIGKILL and "fault plan armed" in r.stderr
    r = _cli(["predict", ini, "--device", "cpu", "--supervised"])
    assert r.returncode == 2 and "apply to the train verb" in r.stderr


def test_resilience_and_the_supervising_cli_import_no_torch():
    code = ("import sys\n"
            "import fast_tffm_tpu_torch.resilience, fast_tffm_tpu_torch.cli\n"
            "assert 'torch' not in sys.modules, 'torch'\n"
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith('fast_tffm_tpu.')]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr


def test_a_packed_run_rolls_back_into_its_packed_tensors(tmp_path):
    """table_layout = packed, element accumulator: the rollback packs the
    restored logical arrays and copies them into the live packed tensors;
    the run ends within the training tolerance of the rows run's rollback
    (the same skip)."""
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    kw = dict(on_nan="rollback", save_every_epochs=1)
    _, rows, _ = _port_run(tmp_path, init, "rows.ckpt", "nan@30:33", **kw)
    cfg, packed, _ = _port_run(tmp_path, init, "packed.ckpt", "nan@30:33",
                               table_layout="packed", **kw)
    assert packed.layout == "packed" and packed.step == rows.step == 28
    logical = unpack_state(packed, build_model(cfg))
    assert torch.equal(logical.table, rows.table)
    assert torch.equal(logical.table_accum, rows.table_accum)
