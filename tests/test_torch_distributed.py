"""Port: the coordination runtime of multi-process training
(``fast_tffm_tpu_torch/distributed.py``) and what ``dist_train`` refuses,
on the CPU — the counterparts of the ``tests/test_distributed.py`` cases
this slice ports.

* The ``FileKV`` and the process-group store's ``StoreKV``: set, get,
  barrier; the runtime's signature publish and cursor vector, ``agree``
  detecting a desync, ``PeerLostError`` on a timeout, the inactive runtime
  as a no-op; the JAX runtime and the port's on one ``FileKV`` directory.
* ``host_metrics_path``, the record envelope's process identity,
  ``_resolve_cursor``'s host entry and its refusal of another topology.
* The ``[Distributed]`` keys: validated with the JAX words, read from every
  repo config as the JAX ``Config`` reads them.
* A two-rank ``dist_train`` with ``input_assignment = files``.
* The refusals: the JAX package's, in its words (orbax with delta saves).
  What an earlier slice refused and now runs is held running: the
  resident epoch under ``dist_train``, async and delta saves across
  processes, ``host_stall_timeout_s``, a pod supervisor's child, the pod
  CLI and ``--fault-process``.
"""

import json
import os
import pickle
import subprocess
import sys
import threading
import traceback
import uuid

import numpy as np
import pytest
import torch.distributed as dist

from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.distributed import DistributedRuntime as JaxRuntime
from fast_tffm_tpu.distributed import FileKV as JaxFileKV
from fast_tffm_tpu.training import dist_train as jax_dist_train
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.distributed import (
    DistributedRuntime,
    FileKV,
    PeerLostError,
    StoreKV,
    host_metrics_path,
    initialize_runtime,
    process_identity,
)
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.training import _dist_refusals, _files_fingerprint, _resolve_cursor
from fast_tffm_tpu_torch.training import dist_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")


def quiet(*_):
    pass


def _pair(kv_factory, **kw):
    return (DistributedRuntime(0, 2, kv_factory(), instance=1, **kw),
            DistributedRuntime(1, 2, kv_factory(), instance=1, **kw))


def _file_kv(tmp_path):
    root = str(tmp_path / "kv")
    return lambda: FileKV(root, poll_s=0.01)


def _store_kv(tmp_path):
    path = str(tmp_path / "store")
    return lambda: StoreKV(dist.FileStore(path, 2))


KVS = {"file": _file_kv, "store": _store_kv}


@pytest.mark.parametrize("kind", KVS)
def test_kv_set_get_and_barrier(tmp_path, kind):
    make = KVS[kind](tmp_path)
    kv = make()
    kv.set("a/b", "v1")
    assert make().get("a/b", timeout_s=1) == "v1"
    with pytest.raises(TimeoutError):
        kv.get("missing", timeout_s=0.05)
    done = []

    def arrive(p, kv):
        kv.barrier("bar0", timeout_s=5, process_count=2, process_index=p)
        done.append(p)

    t = threading.Thread(target=arrive, args=(0, make()))
    t.start()
    arrive(1, kv)
    t.join(timeout=5)
    assert sorted(done) == [0, 1]


@pytest.mark.parametrize("kind", KVS)
def test_runtime_signature_and_cursor_vector(tmp_path, kind):
    r0, r1 = _pair(KVS[kind](tmp_path), barrier_timeout_s=5.0)
    assert r0.active and r0.is_lead and not r1.is_lead
    r0.publish_signature(1, "sig-abc", "full")
    assert r1.await_signature(1) == {"sig": "sig-abc", "meta": "full"}
    got = {}

    def post1():
        got["r1"] = r1.share_cursor(7, {"epoch": 1, "batch_in_epoch": 9})

    t = threading.Thread(target=post1)
    t.start()
    vec = r0.share_cursor(7, {"epoch": 1, "batch_in_epoch": 9})
    t.join(timeout=5)
    assert got["r1"] is None
    assert [c["batch_in_epoch"] for c in vec] == [9, 9]
    # broadcast and allgather, as the run id and the files-mode row counts use them
    out = {}
    t = threading.Thread(target=lambda: out.update(
        b=r1.broadcast("run_id", None), g=r1.allgather("rows", 5)))
    t.start()
    assert r0.broadcast("run_id", "r-7") == "r-7"
    assert r0.allgather("rows", 3) == [3, 5]
    t.join(timeout=5)
    assert out == {"b": "r-7", "g": [3, 5]}


@pytest.mark.parametrize("kind", KVS)
def test_runtime_agree_detects_desync(tmp_path, kind):
    r0, r1 = _pair(KVS[kind](tmp_path), barrier_timeout_s=5.0)
    out = {}

    def side(r, v):
        try:
            r.agree("head", v)
            out[r.process_index] = "ok"
        except RuntimeError as e:
            out[r.process_index] = str(e)

    t = threading.Thread(target=side, args=(r1, {"head": "B"}))
    t.start()
    side(r0, {"head": "A"})
    t.join(timeout=5)
    assert "disagree" in out[0] and "disagree" in out[1]


@pytest.mark.parametrize("kind", KVS)
def test_runtime_peer_lost_on_timeout(tmp_path, kind):
    r0, _ = _pair(KVS[kind](tmp_path), barrier_timeout_s=0.05)
    with pytest.raises(PeerLostError):
        r0.barrier("alone")
    with pytest.raises(PeerLostError):
        r0.await_signature(3)


def test_inactive_runtime_is_noop():
    r = DistributedRuntime(0, 1, None)
    assert not r.active
    r.barrier("x")
    r.publish_signature(1, "s")
    assert r.await_signature(1) is None
    assert r.share_cursor(1, {"epoch": 0}) is None
    assert r.agree("t", {"v": 1}) == [{"v": 1}]
    assert r.allgather("t", 3) == [3] and r.broadcast("t", 4) == 4


def test_jax_and_port_runtimes_share_one_file_kv(tmp_path):
    """The keys and payloads are the JAX runtime's: a JAX process and a port
    process agree, barrier and exchange a signature over one directory."""
    root = str(tmp_path / "kv")
    jax_r = JaxRuntime(0, 2, JaxFileKV(root, poll_s=0.01), instance=1, barrier_timeout_s=5.0)
    port_r = DistributedRuntime(1, 2, FileKV(root, poll_s=0.01), instance=1,
                                barrier_timeout_s=5.0)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        a=port_r.agree("restore", {"step": 3}), s=port_r.await_signature(1)))
    t.start()
    assert jax_r.agree("restore", {"step": 3}) == [{"step": 3}, {"step": 3}]
    jax_r.publish_signature(1, "sig", "full")
    t.join(timeout=5)
    assert out == {"a": [{"step": 3}, {"step": 3}], "s": {"sig": "sig", "meta": "full"}}


# -- per-rank paths, the envelope, the cursor vector --------------------------


def test_host_metrics_path():
    assert host_metrics_path("", 1) == ""
    assert host_metrics_path("run.jsonl", 0) == "run.jsonl"
    assert host_metrics_path("run.jsonl", 1) == "run.p1.jsonl"
    assert host_metrics_path("/a/b/metrics", 2) == "/a/b/metrics.p2"


def test_envelope_carries_process_identity(tmp_path, monkeypatch):
    monkeypatch.setenv("FM_DIST_PROCESS_ID", "1")
    monkeypatch.setenv("FM_DIST_PROCESSES", "2")
    assert process_identity() == (1, 2)
    path = str(tmp_path / "m.jsonl")
    mon = RunMonitor(path, run_id="r-env")
    mon.emit("train", step=3, epoch=0, loss=0.5, examples_per_sec=1.0,
             examples_per_sec_per_chip=1.0)
    mon.close()
    recs = [json.loads(line) for line in open(path)]
    assert all(r["process_index"] == 1 and r["process_count"] == 2 for r in recs)


def test_resolve_cursor_picks_host_entry_and_rejects_topology_change(tmp_path):
    f = tmp_path / "t.libsvm"
    f.write_text("1 3:1.0\n" * 64)
    cfg = Config(model="fm", vocabulary_size=8, train_files=(str(f),), batch_size=4,
                 epoch_num=4).validate()

    def cursor(**over):
        c = {"version": 1, "epoch": 2, "batch_in_epoch": 5, "batch_size": 4, "shuffle": False,
             "shuffle_seed": 0, "steps_per_call": 1, "files": _files_fingerprint(cfg.train_files)}
        c.update(over)
        return c

    logs = []
    one = [{"process": 0, "epoch": 2, "batch_in_epoch": 5}]
    assert _resolve_cursor(cfg, cursor(process_count=1, hosts=one), logs.append) == (2, 5)
    two = [{"process": 0, "epoch": 2, "batch_in_epoch": 5},
           {"process": 1, "epoch": 2, "batch_in_epoch": 5}]
    # A 2-host vector resumes each of two ranks at its entry ...
    assert _resolve_cursor(cfg, cursor(process_count=2, hosts=two), logs.append, 1, 2) == (2, 5)
    # ... and cannot resume on one: the loud legacy start.
    assert _resolve_cursor(cfg, cursor(process_count=2, hosts=two), logs.append) == (0, 0)
    assert any("saved by 2 host(s), this run has 1" in line for line in logs)
    # A vector whose entries disagree: the same loud start.
    bad = [{"process": 0, "epoch": 2, "batch_in_epoch": 5},
           {"process": 1, "epoch": 2, "batch_in_epoch": 6}]
    assert _resolve_cursor(cfg, cursor(process_count=2, hosts=bad), logs.append, 0, 2) == (0, 0)
    assert any("disagrees across hosts" in line for line in logs)
    # The host entry wins over the top-level position.
    host = [{"process": 0, "epoch": 1, "batch_in_epoch": 0}]
    assert _resolve_cursor(cfg, cursor(process_count=1, hosts=host), logs.append) == (1, 0)


# -- the [Distributed] keys ---------------------------------------------------


def test_distributed_config_keys_validate():
    cfg = Config(model="fm", input_assignment="files", heartbeat_s=1.0,
                 host_stall_timeout_s=30.0, barrier_timeout_s=60.0,
                 runtime_dir="/tmp/x").validate()
    assert cfg.input_assignment == "files"
    for kw, needle in ((dict(input_assignment="shards"), "input_assignment"),
                       (dict(barrier_timeout_s=0), "barrier_timeout_s"),
                       (dict(heartbeat_s=0), "heartbeat_s"),
                       (dict(host_stall_timeout_s=-1), "host_stall_timeout_s"),
                       (dict(lookup="ring"), "unknown lookup"),
                       (dict(lookup_overflow="drop"), "unknown lookup_overflow")):
        with pytest.raises(ValueError, match=needle) as got:
            Config(model="fm", **kw).validate()
        with pytest.raises(ValueError) as want:
            JaxConfig(model="fm", **kw).validate()
        assert str(got.value) == str(want.value)


def test_every_jax_key_is_read(tmp_path):
    """An INI that sets every [Distributed] key, vocabulary_block_num and
    binary_cache_wait loads into the same values in both packages."""
    from fast_tffm_tpu.config import load_config as jax_load_config
    from fast_tffm_tpu_torch.config import load_config

    ini = tmp_path / "d.cfg"
    ini.write_text(
        "[General]\nmodel = fm\nvocabulary_block_num = 4\n"
        "[Train]\nbinary_cache_wait = 12.5\n"
        "[Distributed]\ndata_parallel = 2\nrow_parallel = 2\nlookup = ALLTOALL\n"
        "lookup_capacity_factor = 1.5\nlookup_overflow = abort\n"
        "coordinator_address = 127.0.0.1:1234\nnum_processes = 4\nprocess_id = 3\n"
        "input_assignment = files\nruntime_dir = /tmp/rt\nheartbeat_s = 0.5\n"
        "host_stall_timeout_s = 3\nbarrier_timeout_s = 9\n")
    got, want = load_config(str(ini)), jax_load_config(str(ini))
    for f in ("vocabulary_block_num", "binary_cache_wait", "data_parallel", "row_parallel",
              "lookup", "lookup_capacity_factor", "lookup_overflow", "coordinator_address",
              "num_processes", "process_id", "input_assignment", "runtime_dir", "heartbeat_s",
              "host_stall_timeout_s", "barrier_timeout_s"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.lookup == "alltoall" and got.process_id == 3


# -- a two-rank run over shard-disjoint files ---------------------------------


def _files_rank(rank, world, store, kw, out):
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    logs = []
    try:
        dist_train(Config(**kw).validate(), device="cpu", log=logs.append)
        payload = ("ok", logs)
    except BaseException:
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)
    dist.destroy_process_group()


def test_two_ranks_with_input_assignment_files(tmp_path):
    import multiprocessing as mp

    lines = open(TRAIN).read().splitlines()
    files = []
    for i, (lo, hi) in enumerate(((0, 200), (200, 330))):
        p = tmp_path / f"part{i}.libsvm"
        p.write_text("\n".join(lines[lo:hi]) + "\n")
        files.append(str(p))
    kw = dict(model="fm", factor_num=8, vocabulary_size=256, max_nnz=8, batch_size=20,
              train_files=tuple(files), weight_files=(1.0, 2.0), input_assignment="files",
              model_file=str(tmp_path / "m.ckpt"), log_every=5, learning_rate=0.05,
              metrics_path=str(tmp_path / "m.jsonl"), telemetry_profile_costs=False)
    ctx = mp.get_context("spawn")
    store, outs = str(tmp_path / f"s-{uuid.uuid4().hex}"), [str(tmp_path / f"o{r}") for r in (0, 1)]
    procs = [ctx.Process(target=_files_rank, args=(r, 2, store, kw, outs[r])) for r in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    for p in procs:
        if p.is_alive():
            p.kill()
    logs = []
    for out in outs:
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", value
        logs.append(value)
    # 200 rows on rank 0 and 130 on rank 1, 10 rows a rank a step: 20 steps,
    # rank 1's last 7 all weight-0 padding.
    assert any("host 0 owns 1 file(s) / 200 rows, 20 steps/epoch, 10 rows/process/step" in x
               for x in logs[0])
    assert any("host 1 owns 1 file(s) / 130 rows, 20 steps/epoch" in x for x in logs[1])
    with np.load(kw["model_file"]) as z:
        assert int(z["step"]) == 20 and np.isfinite(z["table"]).all()
        cursor = json.loads(bytes(z["input_cursor"]).decode())
    assert cursor["process_count"] == 2 and [h["epoch"] for h in cursor["hosts"]] == [1, 1]
    # One telemetry file a rank, one run id.
    ids = {json.loads(line)["run_id"] for path in (kw["metrics_path"],
                                                    str(tmp_path / "m.p1.jsonl"))
           for line in open(path)}
    assert len(ids) == 1


# -- refusals -------------------------------------------------------------------


def _cfg(tmp_path, **kw):
    base = dict(model="fm", factor_num=4, vocabulary_size=256, max_nnz=8, batch_size=20,
                train_files=(TRAIN,), model_file=str(tmp_path / "m.ckpt"))
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [
    dict(tail="pallas"),
    dict(paramstore=True),
    dict(dedup_gather_rows=64),
    dict(online_accum_restart_steps=10),
    dict(device_cache=True, shuffle=True),
    dict(weight_files=(1.0, 2.0)),
], ids=["pallas", "paramstore", "dedup", "accum_restart", "cache_shuffle", "weights"])
def test_dist_train_refuses_what_jax_refuses_in_its_words(tmp_path, kw):
    with pytest.raises(ValueError) as want:
        jax_dist_train(JaxConfig(**_cfg(tmp_path, **kw)).validate(), log=quiet)
    with pytest.raises(ValueError) as got:
        dist_train(Config(**_cfg(tmp_path, **kw)).validate(), log=quiet, device="cpu")
    assert str(got.value) == str(want.value)


def test_dist_train_refuses_follow_in_the_jax_words(tmp_path):
    cfg = Config(**_cfg(tmp_path, online_follow=True)).validate()
    with pytest.raises(ValueError, match="follow = true is single-process"):
        _dist_refusals(cfg)


@pytest.mark.parametrize("kw,world,needle", [
    (dict(device_cache=True, binary_cache=True), 1, "rows resident, sharded over 1 devices"),
    (dict(async_save=True), 2, "async"),
    (dict(delta_every_steps=4), 2, "delta"),
])
def test_what_this_slice_leaves_out_is_refused_naming_the_roadmap(tmp_path, kw, world, needle):
    """What the previous slice refused and this one ports: no refusal is
    left, the resident epoch trains under dist_train, and a two-process
    checkpointer keeps its async and delta boundaries."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer

    shutil.copy(TRAIN, tmp_path / "t.libsvm")  # its FMB cache is made beside it
    cfg = Config(**_cfg(tmp_path, train_files=(str(tmp_path / "t.libsvm"),), **kw)).validate()
    _dist_refusals(cfg)
    if world == 1:
        logs = []
        dist_train(cfg, log=logs.append, device="cpu")
        assert any(needle in line for line in logs)
        return
    rt = DistributedRuntime(1, 2, FileKV(str(tmp_path / "kv")), instance=1)
    ckpt = AsyncCheckpointer(cfg.model_file, device="cpu", async_save=cfg.async_save,
                             delta_every_steps=cfg.delta_every_steps, vocab=256, row_dim=5,
                             runtime=rt)
    assert ckpt._rt is rt and (ckpt._async if needle == "async" else ckpt.delta_enabled)


def test_pod_supervision_is_refused(tmp_path, monkeypatch):
    """Pod supervision runs: host_stall_timeout_s > 0 brings a process up,
    and a pod supervisor's child joins its generation (one process: no
    group), with its watcher and its heartbeat."""
    cfg = Config(**_cfg(tmp_path, host_stall_timeout_s=5.0)).validate()
    rt = initialize_runtime(cfg, log=quiet, device="cpu")
    assert not rt.active and rt.heartbeat is None and rt.watcher is None
    from fast_tffm_tpu_torch.distributed import read_heartbeat, write_generation

    rdir = str(tmp_path / "rt")
    write_generation(rdir, {"generation": 2, "coordinator": "127.0.0.1:1", "num_processes": 1,
                            "cause": "start"})
    monkeypatch.setenv("FM_DIST_GENERATION", "1")
    monkeypatch.setenv("FM_DIST_RUNTIME_DIR", rdir)
    monkeypatch.setenv("FM_DIST_PROCESS_ID", "0")
    monkeypatch.setenv("FM_DIST_PROCESSES", "1")
    logs = []
    rt = initialize_runtime(Config(**_cfg(tmp_path, heartbeat_s=0.05)).validate(),
                            log=logs.append, device="cpu")
    try:
        assert "joining pod generation 2 as process 0/1" in logs[0]
        assert os.environ["FM_DIST_GENERATION"] == "2" and rt.runtime_dir == rdir
        assert rt.watcher is not None and rt.heartbeat is not None
        rt.heartbeat.set_step(7)
    finally:
        rt.watcher.close()
        rt.heartbeat.close()
    assert read_heartbeat(rdir, 0)[0]["step"] == 7


def _cli(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "fast_tffm_tpu_torch.cli", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=env)


def test_cli_refuses_fault_process_and_pod_supervision(tmp_path):
    """--fault-process and a two-process dist_train --supervised (a pod)
    run; --resume still applies to the training verbs only."""
    ini = tmp_path / "c.cfg"
    ini.write_text(f"[General]\nmodel = fm\nfactor_num = 4\nvocabulary_size = 256\n"
                   f"model_file = {tmp_path / 'm.ckpt'}\n"
                   f"[Train]\ntrain_files = {TRAIN}\nbatch_size = 100\nmax_nnz = 8\n"
                   "[Distributed]\nnum_processes = 2\n")
    r = _cli(["dist_train", str(ini), "--device", "cpu", "--supervised", "--fault-process", "1"])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "supervisor: pod completed cleanly after 0 restart incident(s)" in r.stderr
    assert r.stdout.count("training done:") == 2
    with np.load(tmp_path / "m.ckpt") as z:
        assert json.loads(bytes(z["input_cursor"]).decode())["process_count"] == 2
    r = _cli(["dist_predict", str(ini), "--device", "cpu", "--resume"])
    assert r.returncode == 2 and "--resume applies to the train and dist_train verbs" in r.stderr


def test_orbax_is_refused_naming_the_later_slice():
    """Once refused as a later slice, orbax now validates as the JAX
    package's config does, and dist_train refuses only what the JAX
    package refuses with it (delta saves), in its words."""
    Config(model="fm", checkpoint_format="orbax").validate()
    JaxConfig(model="fm", checkpoint_format="orbax").validate()
    errors = []
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match="requires checkpoint_format = npz") as e:
            cls(model="fm", checkpoint_format="orbax", delta_every_steps=2).validate()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_dist_verbs_need_a_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(**_cfg(tmp_path)).validate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_train(cfg, log=quiet)
