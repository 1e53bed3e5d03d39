"""Port: pod supervision of multi-process training on the CPU — the
counterparts of the pod cases of ``tests/test_distributed.py`` and of
``tests/test_pod_failover.py``.

* Units on the port's functions: the generation file's round trip and
  wait, ``reexec_argv`` equal to the JAX function's on a table of argvs,
  the ``GenerationWatcher`` (an injected ``exec_fn``), the heartbeat and the
  ``HostMonitor``'s once-per-episode latch, the pod ``Supervisor`` on fake
  children (only the dead one relaunched, a bounded give-up, a give-up once
  part of the pod finished, the straggler kill, ``runtime_dir`` required).
* The files across packages: a generation file and heartbeats written by
  either package are read by the other, and either package's watcher
  follows the other's bump.
* The peer monitor in the training loop: two spawned gloo ranks whose
  heartbeats go stale write kind=stall records with the peer fields.
* A real pod: ``python -m fast_tffm_tpu_torch.cli dist_train cfg
  --supervised --device cpu`` with ``num_processes = 2`` on the JAX
  scenario's config (320 rows, batch 32, 2 epochs, a delta every 3 steps).
  ``kill@8`` on the non-writer host: the supervisor relaunches only that
  host, the writer re-execs in place (the same PID), and every step's last
  loss and the final table are bitwise the uninterrupted pod's; the two
  hosts' telemetry files merge in ``tools/report.py`` with the host-level
  faults.  Slow-marked, as the JAX package marks its own: the writer's
  kill, ``kill_publish`` during the first full and during a delta
  publish, a SIGSTOPped straggler, and the uninterrupted pod against the
  JAX package's pod from one shared npz.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from fast_tffm_tpu.distributed import GenerationWatcher as JaxGenerationWatcher
from fast_tffm_tpu.distributed import HeartbeatWriter as JaxHeartbeatWriter
from fast_tffm_tpu.distributed import read_generation as jax_read_generation
from fast_tffm_tpu.distributed import read_heartbeat as jax_read_heartbeat
from fast_tffm_tpu.distributed import reexec_argv as jax_reexec_argv
from fast_tffm_tpu.distributed import write_generation as jax_write_generation
from fast_tffm_tpu_torch.distributed import (
    GenerationWatcher,
    HeartbeatWriter,
    HostMonitor,
    PeerLostError,
    read_generation,
    read_heartbeat,
    reexec_argv,
    wait_for_generation,
    write_generation,
)
from fast_tffm_tpu_torch.resilience import Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, BATCH, EPOCHS, DELTA_EVERY = 320, 32, 2, 3
STEPS = ROWS // BATCH * EPOCHS  # 20 global steps
POD_TIMEOUT_S = 240


def quiet(*_):
    pass


def _until(cond, timeout_s=3.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


# -- the generation file, re-exec, the watcher ---------------------------------


def test_generation_roundtrip_and_wait(tmp_path):
    d = str(tmp_path)
    assert read_generation(d) is None
    write_generation(d, {"generation": 0, "coordinator": "h:1", "num_processes": 2})
    assert read_generation(d)["generation"] == 0
    with pytest.raises(PeerLostError):
        wait_for_generation(d, at_least=1, timeout_s=0.1, poll_s=0.02)
    write_generation(d, {"generation": 2, "coordinator": "h:2", "num_processes": 2})
    assert wait_for_generation(d, at_least=1, timeout_s=1)["coordinator"] == "h:2"


REEXEC_ARGVS = [
    ["cli.py", "dist_train", "run.cfg", "--fault-plan", "kill@5", "--fault-seed", "3",
     "--fault-horizon", "100", "--fault-process", "1", "--metrics-path", "m.jsonl"],
    ["cli.py", "dist_train", "run.cfg", "--metrics-path", "m.jsonl", "--resume"],
    ["-m", "fast_tffm_tpu_torch.cli", "dist_train", "c.cfg", "--device", "cpu", "--resume",
     "--run-id", "r-1", "--resume"],
    ["-m", "fast_tffm_tpu_torch.cli", "dist_train", "c.cfg", "--fault-plan=kill@3",
     "--fault-process", "-1", "--device", "cuda"],
    [],
]


@pytest.mark.parametrize("argv", REEXEC_ARGVS)
def test_reexec_argv_is_the_jax_function(argv):
    out = reexec_argv(argv)
    assert out == jax_reexec_argv(argv)
    assert out[-1] == "--resume" and out.count("--resume") == 1
    assert not [a for a in out if a.startswith("--fault")]
    assert reexec_argv(out) == out  # idempotent


def test_generation_watcher_reexecs_on_bump(tmp_path):
    d = str(tmp_path)
    write_generation(d, {"generation": 0, "coordinator": "h:1", "num_processes": 2})
    fired = []
    w = GenerationWatcher(d, 0, argv=["cli.py", "dist_train", "c.cfg"], poll_s=0.02, log=quiet,
                          exec_fn=lambda gen, argv: fired.append((gen, argv)))
    try:
        time.sleep(0.1)
        assert fired == []  # the same generation: nothing
        write_generation(d, {"generation": 1, "coordinator": "h:2", "num_processes": 2,
                             "cause": "host [1] crashed"})
        _until(lambda: fired)
    finally:
        w.close()
    assert fired == [(1, ["cli.py", "dist_train", "c.cfg", "--resume"])]


def test_the_default_watcher_argv_is_the_interpreter_command_line(tmp_path):
    w = GenerationWatcher(str(tmp_path), 0, log=quiet, exec_fn=lambda *a: None)
    w.close()
    assert w._argv == sys.orig_argv[1:]


# -- heartbeats and the host monitor ---------------------------------------------


def test_heartbeat_write_and_read(tmp_path):
    d = str(tmp_path)
    hb = HeartbeatWriter(d, 1, interval_s=0.05)
    try:
        hb.set_step(17)
        time.sleep(0.15)
        payload, age = read_heartbeat(d, 1)
    finally:
        hb.close()
    assert payload["process"] == 1 and payload["step"] == 17
    assert age is not None and age < 5
    assert read_heartbeat(d, 0) == (None, None)


def test_heartbeat_close_writes_the_last_step(tmp_path):
    d = str(tmp_path)
    hb = HeartbeatWriter(d, 0, interval_s=60.0)
    _until(lambda: read_heartbeat(d, 0)[0] is not None)
    hb.set_step(40)
    hb.close()
    assert read_heartbeat(d, 0)[0]["step"] == 40


def _stale_hb(d, p, step):
    path = os.path.join(d, f"hb-{p}.json")
    with open(path, "w") as f:
        json.dump({"process": p, "step": step, "wall": 0}, f)
    stale = time.time() - 60
    os.utime(path, (stale, stale))
    return path, stale


def test_host_monitor_classifies_lost_peer_once_per_episode(tmp_path):
    d = str(tmp_path)
    path, stale = _stale_hb(d, 1, 4)
    events = []
    mon = HostMonitor(d, 0, 2, timeout_s=0.2, on_event=lambda *a: events.append(a), poll_s=0.03)
    try:
        _until(lambda: events)
        time.sleep(0.15)  # latched: no second event while still stale
        n_latched = len(events)
        os.utime(path)  # the peer freshens: the episode re-arms
        time.sleep(0.1)
        os.utime(path, (stale, stale))
        _until(lambda: len(events) > n_latched)
    finally:
        mon.close()
    assert n_latched == 1
    peer, classification, detail = events[0]
    assert peer == 1 and classification == "host-heartbeat-lost" and detail["last_step"] == 4
    assert len(events) == 2


def test_host_monitor_leaves_a_live_peer_alone_however_far_behind(tmp_path):
    """A peer that still writes is never classified, however far its step
    trails ours (lock-stepped ranks cannot fall behind; the supervisor's
    heartbeat-age kill is the straggler path)."""
    d = str(tmp_path)
    hb = HeartbeatWriter(d, 1, interval_s=0.02)
    hb.set_step(3)
    events = []
    mon = HostMonitor(d, 0, 2, timeout_s=0.5, on_event=lambda *a: events.append(a), poll_s=0.03)
    try:
        _until(lambda: read_heartbeat(d, 1)[0] is not None)
        time.sleep(0.8)  # past the timeout, the peer writing all along
    finally:
        mon.close()
        hb.close()
    assert events == []


# -- the files across packages -------------------------------------------------


def test_generation_files_cross_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    info = {"generation": 3, "coordinator": "127.0.0.1:7", "num_processes": 2, "cause": "x"}
    jax_write_generation(a, info)
    write_generation(b, info)
    assert read_generation(a) == jax_read_generation(b) == info
    assert open(os.path.join(a, "generation.json")).read() == \
        open(os.path.join(b, "generation.json")).read()


def test_heartbeats_cross_packages(tmp_path):
    d = str(tmp_path)
    jhb, phb = JaxHeartbeatWriter(d, 0, interval_s=0.02), HeartbeatWriter(d, 1, interval_s=0.02)
    try:
        jhb.set_step(5)
        phb.set_step(6)
        assert _until(lambda: (read_heartbeat(d, 0)[0] or {}).get("step") == 5
                      and (jax_read_heartbeat(d, 1)[0] or {}).get("step") == 6)
    finally:
        jhb.close()
        phb.close()
    for p, step in ((0, 5), (1, 6)):
        mine, theirs = read_heartbeat(d, p)[0], jax_read_heartbeat(d, p)[0]
        assert mine == theirs and set(mine) == {"process", "step", "wall"}
        assert mine["process"] == p and mine["step"] == step


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_watcher_follows_the_other_packages_bump(tmp_path, writer):
    d = str(tmp_path)
    write, watch = ((jax_write_generation, GenerationWatcher) if writer == "jax"
                    else (write_generation, JaxGenerationWatcher))
    write(d, {"generation": 0, "coordinator": "h:1", "num_processes": 2})
    fired = []
    w = watch(d, 0, argv=["x", "dist_train"], poll_s=0.02, log=quiet,
              exec_fn=lambda gen, argv: fired.append((gen, argv)))
    try:
        write(d, {"generation": 1, "coordinator": "h:2", "num_processes": 2, "cause": "c"})
        _until(lambda: fired)
    finally:
        w.close()
    assert fired == [(1, ["x", "dist_train", "--resume"])]


# -- the pod supervisor on fake children ----------------------------------------

_POD_CHILD = textwrap.dedent(
    """
    import os, sys, time
    tmp, p = sys.argv[1], os.environ["FM_DIST_PROCESS_ID"]
    gen = os.environ["FM_DIST_GENERATION"]
    with open(os.path.join(tmp, f"launch-{p}-{gen}"), "a") as f:
        f.write(str(os.getpid()) + "\\n")
    if p == "1":
        marker = os.path.join(tmp, "crashed-once")
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            print("step 5 epoch 0 loss 0.5", flush=True)
            os._exit(9)
        print("step 6 epoch 0 loss 0.4", flush=True)
        open(os.path.join(tmp, "go"), "w").write("x")
        sys.exit(0)
    print("step 5 epoch 0 loss 0.5", flush=True)
    for _ in range(600):
        if os.path.exists(os.path.join(tmp, "go")):
            sys.exit(0)
        time.sleep(0.05)
    sys.exit(7)
    """
)


def _records(path, kind=None):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [r for r in recs if kind is None or r.get("kind") == kind]


def test_pod_supervisor_restarts_only_the_dead_child(tmp_path):
    d = str(tmp_path)
    metrics = str(tmp_path / "sup.jsonl")
    launches = []

    def build_cmd(attempt, resume, proc):
        launches.append((attempt, resume, proc))
        return [sys.executable, "-c", _POD_CHILD, d]

    sup = Supervisor(build_cmd, model_file=str(tmp_path / "m.ckpt"), max_restarts=3,
                     backoff_s=0.01, backoff_max_s=0.05, metrics_path=metrics, run_id="pod-run",
                     log=quiet, processes=2, runtime_dir=d)
    assert sup.run() == 0
    assert sup.restarts == 1
    assert launches == [(0, False, 0), (0, False, 1), (1, False, 1)]
    assert len(open(tmp_path / "launch-0-0").read().split()) == 1  # host 0 survived
    assert os.path.exists(tmp_path / "launch-1-1")  # host 1 joined generation 1
    gen = read_generation(d)
    assert gen["generation"] == 1 and "crashed" in gen["cause"]
    recs = _records(metrics)
    assert all(r["run_id"] == "pod-run" for r in recs)
    faults = [r for r in recs if r["kind"] == "fault"]
    assert [f["event"] for f in faults] == ["crash"] and faults[0]["process"] == 1
    (restart,) = [r for r in recs if r["kind"] == "restart"]
    assert restart["process"] == 1 and restart["attempt"] == 1 and restart["exit_code"] == 9
    (summary,) = [r for r in recs if r["kind"] == "summary"]
    assert summary["supervisor_restarts"] == 1


def test_pod_supervisor_gives_up_after_bounded_incidents(tmp_path):
    sup = Supervisor(lambda attempt, resume, proc: [sys.executable, "-c", "import os; os._exit(3)"],
                     model_file=str(tmp_path / "m.ckpt"), max_restarts=1, backoff_s=0.01,
                     metrics_path=str(tmp_path / "sup.jsonl"), log=quiet, processes=2,
                     runtime_dir=str(tmp_path))
    assert sup.run() == 3
    assert sup.restarts == 1


def test_pod_supervisor_gives_up_when_part_of_the_pod_finished(tmp_path):
    child = "import os, sys, time; p = os.environ['FM_DIST_PROCESS_ID']\n" \
            "time.sleep(0.6) if p == '1' else None\nos._exit(0 if p == '0' else 5)\n"
    logs = []
    sup = Supervisor(lambda attempt, resume, proc: [sys.executable, "-c", child],
                     model_file=str(tmp_path / "m.ckpt"), max_restarts=3, backoff_s=0.01,
                     log=logs.append, processes=2, runtime_dir=str(tmp_path))
    assert sup.run() == 5
    assert sup.restarts == 0
    assert any("cannot re-form the pod" in line for line in logs)


_STRAGGLER_CHILD = textwrap.dedent(
    """
    import json, os, sys, time
    d, p = os.environ["FM_DIST_RUNTIME_DIR"], os.environ["FM_DIST_PROCESS_ID"]
    gen = os.environ["FM_DIST_GENERATION"]

    def beat():
        with open(os.path.join(d, f"hb-{p}.json"), "w") as f:
            json.dump({"process": int(p), "step": 1, "wall": time.time()}, f)

    beat()
    print("step 1 epoch 0 loss 0.5", flush=True)
    go = os.path.join(d, "go")
    if p == "1":
        if gen == "0":
            time.sleep(60)  # alive, its heartbeat going stale: a straggler
        open(go, "w").write("x")
        sys.exit(0)
    for _ in range(600):  # host 0 beats until the relaunched host 1 is done
        if os.path.exists(go):
            sys.exit(0)
        beat()
        time.sleep(0.05)
    sys.exit(7)
    """
)


def test_pod_supervisor_kills_a_straggler_and_relaunches_it(tmp_path):
    metrics = str(tmp_path / "sup.jsonl")
    sup = Supervisor(lambda attempt, resume, proc: [sys.executable, "-c", _STRAGGLER_CHILD],
                     model_file=str(tmp_path / "m.ckpt"), max_restarts=2, backoff_s=0.01,
                     metrics_path=metrics, log=quiet, processes=2, runtime_dir=str(tmp_path),
                     straggler_timeout_s=0.4)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 30
    faults = _records(metrics, "fault")
    assert [f["process"] for f in faults if f["event"] == "straggler_kill"] == [1]
    (crash,) = [f for f in faults if f["event"] == "crash"]
    assert crash["process"] == 1 and crash["signal"] == signal.SIGKILL
    assert sup.restarts == 1


def test_pod_mode_requires_runtime_dir(tmp_path):
    with pytest.raises(ValueError, match="runtime_dir"):
        Supervisor(lambda *a: [], model_file=str(tmp_path / "m"), processes=2)


# -- the peer monitor in the training loop ---------------------------------------


def _stall_job(rank, kw):
    from fast_tffm_tpu_torch.config import Config
    from fast_tffm_tpu_torch.training import dist_train

    def hook(step):
        if step == 5:
            time.sleep(1.0)  # both ranks: the peers' heartbeats go stale

    dist_train(Config(**kw).validate(), device="cpu", log=quiet, step_hook=hook)


def test_a_stale_peer_heartbeat_is_a_stall_record(tmp_path):
    from test_torch_parallel import _spawn

    data = tmp_path / "t.libsvm"
    _write_dataset(data)
    kw = dict(model="fm", factor_num=4, vocabulary_size=64, max_nnz=4, batch_size=BATCH,
              train_files=(str(data),), model_file=str(tmp_path / "m.ckpt"), log_every=5,
              metrics_path=str(tmp_path / "run.jsonl"), runtime_dir=str(tmp_path / "rt"),
              heartbeat_s=60.0, host_stall_timeout_s=0.3, telemetry_profile_costs=False)
    _spawn(tmp_path, 2, _stall_job, kw)
    for p, path in ((0, "run.jsonl"), (1, "run.p1.jsonl")):
        stalls = [r for r in _records(str(tmp_path / path), "stall")
                  if r.get("classification") == "host-heartbeat-lost"]
        assert stalls, path
        assert stalls[0]["peer"] == 1 - p and isinstance(stalls[0]["peer_last_step"], int)
        assert stalls[0]["deadline_s"] == 0.3 and stalls[0]["stacks"] == {}
    # The heartbeats end at the run's last step (closed with a last write).
    for p in (0, 1):
        assert read_heartbeat(str(tmp_path / "rt"), p)[0]["step"] == ROWS // BATCH


# -- a real two-process pod -------------------------------------------------------


def _write_dataset(path):
    rng = np.random.default_rng(7)
    lines = []
    for _ in range(ROWS):
        ids = rng.choice(64, size=4, replace=False)
        lines.append(f"{rng.integers(0, 2)} " + " ".join(f"{i}:1.0" for i in ids))
    path.write_text("\n".join(lines) + "\n")


def _write_cfg(tmp, extra=""):
    cfg = tmp / "run.cfg"
    cfg.write_text(f"""
[General]
model = fm
factor_num = 4
vocabulary_size = 64
model_file = {tmp}/m.ckpt

[Checkpoint]
delta_every_steps = {DELTA_EVERY}

[Train]
train_files = {tmp}/t.libsvm
epoch_num = {EPOCHS}
batch_size = {BATCH}
max_nnz = 4
learning_rate = 0.1
log_every = 1
metrics_path = {tmp}/run.jsonl

[Resilience]
restart_backoff_s = 0.2

[Distributed]
num_processes = 2
barrier_timeout_s = 60
{extra}
""")
    return str(cfg)


def _pod(tmp, *args, package="fast_tffm_tpu_torch.cli", extra="", popen=False):
    cmd = [sys.executable, "-m", package, "dist_train", _write_cfg(tmp, extra), "--supervised"]
    if package.startswith("fast_tffm_tpu_torch"):
        cmd += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    if popen:
        return subprocess.Popen([*cmd, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=env, cwd=REPO)
    return subprocess.run([*cmd, *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=env, cwd=REPO, timeout=POD_TIMEOUT_S)


def _losses(path):
    """step -> the LAST logged loss (a recovered run logs replayed steps
    again; the last is the one the surviving state trained)."""
    return {r["step"]: r["loss"] for r in _records(str(path), "train")}


def _final(tmp):
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    import torch

    return restore_checkpoint(str(tmp / "m.ckpt"), torch.device("cpu"), accum_width=5)


@pytest.fixture(scope="module")
def pod_baseline(tmp_path_factory):
    """One uninterrupted port pod: the oracle of every scenario."""
    tmp = tmp_path_factory.mktemp("pod-base")
    _write_dataset(tmp / "t.libsvm")
    proc = _pod(tmp)
    assert proc.returncode == 0, proc.stdout[-4000:]
    losses = _losses(tmp / "run.jsonl")
    assert len(losses) == STEPS
    return {"losses": losses, "state": _final(tmp)}


def _chaos_pod(tmp, plan, victim, base):
    _write_dataset(tmp / "t.libsvm")
    proc = _pod(tmp, "--fault-plan", plan, "--fault-process", str(victim), "--max-restarts", "3")
    assert proc.returncode == 0, proc.stdout[-6000:]
    got = _losses(tmp / "run.jsonl")
    assert set(base["losses"]) <= set(got)
    for step, loss in base["losses"].items():
        assert got[step] == loss, f"step {step}: {got[step]} != {loss}"
    state = _final(tmp)
    assert state.step == STEPS
    assert np.array_equal(state.table.numpy(), base["state"].table.numpy())
    assert np.array_equal(state.table_accum.numpy(), base["state"].table_accum.numpy())
    crashes = [r for r in _records(str(tmp / "run.jsonl"), "fault") if r.get("event") == "crash"]
    restarts = _records(str(tmp / "run.jsonl"), "restart")
    assert all(c["attempt"] == 0 for c in crashes), crashes
    assert sorted(r["process"] for r in restarts) == sorted(c["process"] for c in crashes)
    assert all(r["attempt"] == 1 for r in restarts)
    assert _records(str(tmp / "run.jsonl"), "summary")[-1]["supervisor_restarts"] == 1
    ids = {r["run_id"] for r in _records(str(tmp / "run.jsonl"))}
    assert len(ids) == 1  # the supervisor and every child: one run id
    return proc, crashes


def test_pod_kill_of_the_non_writer_relaunches_it_alone_bitwise(tmp_path, pod_baseline):
    proc, crashes = _chaos_pod(tmp_path, "kill@8", 1, pod_baseline)
    assert [(c["process"], c["signal"]) for c in crashes] == [(1, signal.SIGKILL)]
    out = proc.stdout
    assert "re-exec'ing into the new pod generation with --resume" in out
    assert "launch host 1 attempt 1 gen 1 (resume)" in out
    assert "launch host 0 attempt 1" not in out  # host 0 re-exec'd, never relaunched
    assert out.count("distributed: joining pod generation 1 as process 0/2") == 1
    assert read_generation(str(tmp_path / "m.ckpt.dist"))["generation"] == 1
    # Both hosts' files merge in the JAX package's report, with the crash
    # as a host-level fault.
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import report

    records = report.load_run(str(tmp_path / "run.jsonl")) + \
        report.load_run(str(tmp_path / "run.p1.jsonl"))
    s = report.summarize(records)
    assert set(s["hosts"]) == {0, 1}
    assert s["host_faults"] >= 1
    assert "Hosts (per-process breakdown)" in report.render(s)


@pytest.mark.slow
def test_pod_kill_of_the_writer_bitwise(tmp_path, pod_baseline):
    _, crashes = _chaos_pod(tmp_path, "kill@8", 0, pod_baseline)
    assert [(c["process"], c["signal"]) for c in crashes if c["process"] == 0] == \
        [(0, signal.SIGKILL)]


@pytest.mark.slow
@pytest.mark.parametrize("publish", [1, 2], ids=["during-full", "during-delta"])
def test_pod_kill_of_the_writer_during_a_publish_bitwise(tmp_path, publish, pod_baseline):
    _, crashes = _chaos_pod(tmp_path, f"kill_publish@{publish}", 0, pod_baseline)
    assert [c["signal"] for c in crashes if c["process"] == 0] == [signal.SIGKILL]


def _pid_of_host(runtime_dir, p):
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        except OSError:
            continue
        if (env.get(b"FM_DIST_RUNTIME_DIR") == runtime_dir.encode()
                and env.get(b"FM_DIST_PROCESS_ID") == str(p).encode()):
            return int(pid)
    return None


@pytest.mark.slow
def test_pod_straggler_is_killed_and_the_pod_ends_bitwise(tmp_path, pod_baseline):
    """Host 1 SIGSTOPped mid-run: alive, its heartbeat going stale.  The
    supervisor SIGKILLs it past host_stall_timeout_s and relaunches it; the
    pod ends bitwise the uninterrupted one."""
    _write_dataset(tmp_path / "t.libsvm")
    rdir = str(tmp_path / "m.ckpt.dist")
    proc = _pod(tmp_path, extra="heartbeat_s = 0.2\nhost_stall_timeout_s = 2", popen=True)
    try:
        assert _until(lambda: any(r["step"] >= 4 for r in _records(str(tmp_path / "run.p1.jsonl"),
                                                                   "train"))
                      if os.path.exists(tmp_path / "run.p1.jsonl") else False, 120)
        pid = _pid_of_host(rdir, 1)
        assert pid is not None
        os.kill(pid, signal.SIGSTOP)
        out, _ = proc.communicate(timeout=POD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-6000:]
    faults = _records(str(tmp_path / "run.jsonl"), "fault")
    assert [f["process"] for f in faults if f["event"] == "straggler_kill"][:1] == [1]
    got = _losses(tmp_path / "run.jsonl")
    for step, loss in pod_baseline["losses"].items():
        assert got[step] == loss, step
    assert np.array_equal(_final(tmp_path).table.numpy(), pod_baseline["state"].table.numpy())


@pytest.mark.slow
def test_the_port_pod_matches_the_jax_pod(tmp_path):
    """The uninterrupted pods of both packages from one shared npz (--resume
    at step 0): every step's loss within 1.4e-6 relative and the tables
    within 3e-8."""
    import jax

    from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
    from fast_tffm_tpu.models import FMModel
    from fast_tffm_tpu.trainer import init_state as jax_init_state

    runs = {}
    for name, package in (("jax", "fast_tffm_tpu.cli"), ("port", "fast_tffm_tpu_torch.cli")):
        tmp = tmp_path / name
        tmp.mkdir()
        _write_dataset(tmp / "t.libsvm")
        state = jax_init_state(FMModel(vocabulary_size=64, factor_num=4), jax.random.key(0))
        table = np.random.default_rng(0).uniform(-0.3, 0.3, (64, 5)).astype(np.float32)
        jax_save_checkpoint(str(tmp / "m.ckpt"), state._replace(table=jax.numpy.asarray(table)))
        proc = _pod(tmp, "--resume", package=package)
        assert proc.returncode == 0, proc.stdout[-4000:]
        runs[name] = (_losses(tmp / "run.jsonl"), _final(tmp))
    (jl, js), (pl, ps) = runs["jax"], runs["port"]
    assert sorted(jl) == sorted(pl) == list(range(1, STEPS + 1))
    np.testing.assert_allclose([pl[s] for s in sorted(pl)], [jl[s] for s in sorted(jl)],
                               rtol=1.4e-6)
    np.testing.assert_allclose(ps.table.numpy(), js.table.numpy(), rtol=0, atol=3e-8)
    np.testing.assert_allclose(ps.table_accum.numpy(), js.table_accum.numpy(), rtol=0, atol=3e-8)
