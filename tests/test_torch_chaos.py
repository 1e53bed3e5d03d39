"""Port: tools/torch_chaos.py against the JAX package's tools/chaos.py, on the CPU.

* The same data bytes: the train path's dataset file and the serving
  request lines, from the same seeds.
* The same artifact keys as the committed JAX artifacts
  (PROBE_MTTR_r06.json, PROBE_MTTR_DIST_r07.json,
  PROBE_SERVE_CHAOS_r16.json), apart from the documented additions
  (``ADDED_KEYS``: the device stamp; and the stamp's ``run_id`` /
  ``schema_version``, which the JAX tool writes too and PROBE_MTTR_r06.json
  predates).
* The tool run as a user runs it, ``--device cpu`` (the three runs start
  together, each a process tree of its own):
  - the train path, one trial: bitwise losses, one crash, one restart with
    an MTTR;
  - ``--processes 2`` on gloo, two trials, so that host 0 and then host 1
    is the victim: bitwise losses, one restart each;
  - ``--serve`` under the default plan: the JAX tool's gates (no request
    unanswered, every delivered score bitwise the fault-free run's, a
    replica restart, a torn reload attempted and survived, no steady
    recompile).
* The torn successor that ``--serve`` publishes is refused by the port's
  scoring restore as by the JAX package's (the tear lands in the
  accumulator member, which a scoring restore reads only through its CRC).
* The faults ``--serve`` found in the port, each on its own: a CPU score
  that depended on the rows scored beside it (ATen's vector loop and its
  scalar tail), a replica that exited at start on a torn publish the next
  reload would retry, and frames a sender wrote to a dead replica while
  the client failed over, never resent.
"""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

import tools.chaos as jax_chaos
import tools.torch_chaos as chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300
RUNS = {
    "train": ["--trials", "1"],
    "pod": ["--trials", "2", "--processes", "2"],
    "serve": ["--serve"],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three tool runs, started together; name -> (rc, output, artifact)."""
    tmp = tmp_path_factory.mktemp("chaos")
    procs = {}
    for name, args in RUNS.items():
        out = tmp / f"{name}.json"
        procs[name] = (out, subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "torch_chaos.py"), "--device", "cpu",
             "--out", str(out), *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            start_new_session=True))
    got = {}
    try:
        for name, (out, proc) in procs.items():
            text, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
            got[name] = (proc.returncode, text,
                         json.loads(out.read_text()) if out.exists() else None)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
    return got


def _committed(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_train_dataset_bytes_equal_the_jax_tools(tmp_path):
    jax_chaos._write_dataset(str(tmp_path / "jax.libsvm"))
    chaos._write_dataset(str(tmp_path / "port.libsvm"))
    assert (tmp_path / "jax.libsvm").read_bytes() == (tmp_path / "port.libsvm").read_bytes()
    assert (chaos.ROWS, chaos.BATCH, chaos.EPOCHS, chaos.STEPS, chaos.DELTA_EVERY) == (
        jax_chaos.ROWS, jax_chaos.BATCH, jax_chaos.EPOCHS, jax_chaos.STEPS, jax_chaos.DELTA_EVERY)
    assert (chaos.SERVE_REPLICAS, chaos.SERVE_REQUESTS, chaos.SERVE_QPS) == (
        jax_chaos.SERVE_REPLICAS, jax_chaos.SERVE_REQUESTS, jax_chaos.SERVE_QPS)


@pytest.mark.parametrize("seed", [1106, 3])
def test_serving_lines_equal_the_jax_tools(seed):
    assert chaos._serve_lines(64, seed) == jax_chaos._serve_lines(64, seed)
    a, b = chaos._parse_serve_lines(chaos._serve_lines(64, seed)), jax_chaos._parse_serve_lines(
        jax_chaos._serve_lines(64, seed))
    assert np.array_equal(np.asarray(a.ids), np.asarray(b.ids))
    assert np.array_equal(np.asarray(a.vals), np.asarray(b.vals))


def test_the_torn_successor_is_refused_by_both_scoring_restores(tmp_path):
    import torch

    from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore
    from fast_tffm_tpu.config import Config as JaxConfig
    from fast_tffm_tpu.config import build_model as jax_build_model
    from fast_tffm_tpu.trainer import init_state as jax_init_state
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    good = str(tmp_path / "m.ckpt")
    torn = chaos._serve_checkpoint(good)
    restore_checkpoint(good, torch.device("cpu"))  # the good file restores
    bad = tmp_path / "torn.ckpt"
    bad.write_bytes(torn)
    with pytest.raises(ValueError, match="torn write"):
        restore_checkpoint(str(bad), torch.device("cpu"))
    import jax

    cfg = JaxConfig(model="fm", factor_num=4, vocabulary_size=4096, max_nnz=6).validate()
    like = jax_init_state(jax_build_model(cfg), jax.random.key(0), 0.1)
    with pytest.raises((ValueError, zipfile.BadZipFile)):
        jax_restore(str(bad), like)


def test_train_path_bitwise_with_one_restart(runs):
    rc, text, art = runs["train"]
    assert rc == 0 and art is not None, text[-4000:]
    path = art["paths"]["train"]
    assert path["all_losses_bit_identical"]
    (trial,) = path["trials"]
    assert trial["supervisor_rc"] == 0 and trial["losses_bit_identical"]
    assert trial["crashes"] == 1 and trial["restarts"] == 1
    assert len(trial["mttr_s"]) == 1 and trial["mttr_s"][0] > 0
    assert art["device"] == "cpu" and art["card"] is None


def test_pod_chaos_on_gloo_kills_each_host_bitwise(runs):
    rc, text, art = runs["pod"]
    assert rc == 0 and art is not None, text[-4000:]
    trials = art["paths"]["dist_train"]["trials"]
    assert [t["victim"] for t in trials] == [0, 1]
    for t in trials:
        assert t["losses_bit_identical"] and t["crashes"] == 1 and t["restarts"] == 1, t
        assert t["processes"] == 2 and t["mttr_s"][0] > 0


def test_serve_chaos_passes_the_jax_gates(runs):
    rc, text, art = runs["serve"]
    assert rc == 0 and art is not None and art["ok"], text[-6000:]
    assert art["unanswered"] == 0 and art["scores_mismatched"] == 0
    assert art["baseline_unscored"] == 0 and art["scored"] == chaos.SERVE_REQUESTS
    assert art["replica_restarts"] >= 1 and art["all_healthy_after"] and art["mttr_s"]
    assert any(v >= 1 for v in art["reload_failures_by_replica"].values())
    assert all(v == 0 for v in art["steady_compiles_by_replica"].values())


@pytest.mark.parametrize("run,committed", [
    ("train", "PROBE_MTTR_r06.json"),
    ("pod", "PROBE_MTTR_DIST_r07.json"),
    ("serve", "PROBE_SERVE_CHAOS_r16.json"),
])
def test_artifact_keys_are_the_jax_artifacts(runs, run, committed):
    art, jax_art = runs[run][2], _committed(committed)
    assert art is not None, runs[run][1][-4000:]
    stamp = {"run_id", "schema_version"}
    assert set(art) == set(jax_art) | set(chaos.ADDED_KEYS) | stamp
    if run == "serve":
        return
    for mode, path in art["paths"].items():
        jax_path = jax_art["paths"][mode]
        assert set(path) == set(jax_path)
        for trial in path["trials"]:
            assert set(trial) == set(jax_path["trials"][0])


def test_a_cpu_score_does_not_depend_on_the_rows_beside_it():
    import torch

    from fast_tffm_tpu_torch.trainer import rowwise_sigmoid

    raw = torch.from_numpy(np.random.default_rng(4).normal(0, 3, 200).astype(np.float32))
    whole = rowwise_sigmoid(raw)
    for size in (1, 7, 8, 64):
        parts = torch.cat([rowwise_sigmoid(raw[i : i + size]) for i in range(0, 200, size)])
        assert torch.equal(parts, whole), size
    assert torch.allclose(whole, torch.sigmoid(raw), rtol=0, atol=1e-7)


def test_a_replica_start_retries_a_torn_checkpoint(monkeypatch):
    from fast_tffm_tpu_torch.checkpoint import TornCheckpointError
    from fast_tffm_tpu_torch.serving import replica

    tries, logs = [], []

    class Engine:
        def __init__(self, cfg, log, device, replica):
            tries.append(1)
            if len(tries) < 3:
                raise TornCheckpointError("torn write")

    monkeypatch.setattr(replica.time, "sleep", lambda s: None)
    assert isinstance(replica._start_engine(Engine, None, logs.append, "cpu", 0), Engine)
    assert len(tries) == 3 and len(logs) == 1  # logged once, retried until whole
    monkeypatch.setattr(replica, "TORN_START_RETRY_S", 0.0)
    tries.clear()
    with pytest.raises(TornCheckpointError):
        replica._start_engine(Engine, None, logs.append, "cpu", 0)


def test_frames_written_to_a_dead_replica_during_failover_are_resent(monkeypatch):
    """A frame a sender writes after the reader saw the replica die, while
    the client fails over, is resent on the new replica with the ones the
    dead replica held; a frame written to the new replica is not."""
    import threading

    from fast_tffm_tpu_torch.serving import client

    class Sock:
        def __init__(self):
            self.sent = []

        def sendall(self, data):
            self.sent.append(data)

        def close(self):
            pass

    fc = object.__new__(client.FrameConnection)
    fc.host, fc.frontend_port, fc.timeout = "127.0.0.1", 1, 1.0
    fc.lock = threading.Lock()
    fc.results, fc._frames, fc._req2seq = {}, {}, {}
    fc._seq, fc._gen, fc._closing, fc._dead, fc.failovers = 0, 1, False, False, 0
    fc._on_result, fc.sock = None, Sock()
    fc.send_packed(b"held", [1])  # in flight when the replica died
    fc.send_packed(b"late", [2])  # written to the dead socket during the failover
    new = Sock()

    def attach(rport, replica):
        with fc.lock:
            fc.sock, fc._gen = new, fc._gen + 1

    monkeypatch.setattr(client, "_hello", lambda *a: {"ok": True, "wire": "binary", "port": 2})
    monkeypatch.setattr(fc, "_attach", attach)
    assert fc._failover()
    fc.send_packed(b"after", [3])
    assert new.sent == [b"held", b"late", b"after"]
    assert all(fr.retried for fr in fc._frames.values() if fr.data != b"after")
