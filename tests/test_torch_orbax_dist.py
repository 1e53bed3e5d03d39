"""Port: orbax checkpoints across processes — ``dist_train`` and
``dist_predict`` on spawned gloo ranks (``tests/test_torch_parallel.py``'s
harness), against the JAX package's reading of the directories.

* Meshes (2, 1), (1, 2) and (2, 2) on the rows layout, packed and the
  alltoall lookup: every row shard is written by its own rank into
  ``ocdbt.process_<rank>/`` (the replicas of data coordinate 1 write
  nothing), rank 0 writes the root and the metadata; the JAX package
  restores the directory bitwise as the port does; the run ends bitwise
  its npz twin; a run stopped by SIGTERM at step 8 and resumed with
  ``--resume`` ends bitwise (losses, table, accumulator) the uninterrupted
  one, each rank reading only the chunk of its own rows; ``dist_predict``
  from the directory scores as from the npz twin.
* A JAX 2 x 2 mesh save (four row chunks) resumed on two port ranks (1, 2):
  each rank reads exactly the two chunks that hold its rows, and the run
  ends bitwise the run resumed from the JAX package's npz of the same
  state.  A saved vocabulary padded for another row count is refused at
  world size > 1 with the JAX package's remedy.
* A real two-process ``cli dist_train --supervised`` pod with
  ``checkpoint_format = orbax`` under ``kill@8`` on host 1 resumes from the
  orbax directory its epoch save left, and ends bitwise the uninterrupted
  pod.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from test_torch_parallel import V, _kw, _spawn, data  # noqa: F401 — the fixture

from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save
from fast_tffm_tpu.models.fm import FMModel as JaxFM
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.checkpoint import latest_step, read_input_cursor, restore_checkpoint
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.prediction import dist_predict
from fast_tffm_tpu_torch.training import dist_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K = 8


def quiet(*_):
    pass


def _job(rank, runs):
    """Each run ``(kwargs, resume, stop_at)``: ``dist_train``, SIGTERM from
    the step hook at ``stop_at``; returns every rank's log per run."""
    out = []
    for kw, resume, stop_at in runs:
        logs = []
        hook = None
        if stop_at:
            def hook(step, at=stop_at, fired=[]):  # noqa: B006 — one list per run
                if step >= at and not fired:
                    fired.append(step)
                    os.kill(os.getpid(), signal.SIGTERM)
        dist_train(Config(**kw).validate(), resume=resume, device="cpu", log=logs.append,
                   step_hook=hook)
        out.append(logs)
    return out


def _predict_job(rank, kws):
    for kw in kws:
        dist_predict(Config(**kw).validate(), log=quiet, device="cpu")


def _losses(path):
    """step -> the last logged loss (a resumed run appends its records)."""
    return {r["step"]: r["loss"] for r in map(json.loads, open(path)) if r["kind"] == "train"}


def _restored(path, acc="element"):
    return restore_checkpoint(path, CPU, accum_width=K + 1 if acc == "element" else 1)


def _same(a, b):
    assert a.step == b.step
    assert torch.equal(a.table, b.table) and torch.equal(a.table_accum, b.table_accum)


CASES = {
    "2x1-rows": ((2, 1), {}),
    "1x2-rows": ((1, 2), {}),
    "2x2-rows": ((2, 2), {}),
    "2x2-packed": ((2, 2), dict(table_layout="packed")),
    "2x2-alltoall": ((2, 2), dict(lookup="alltoall")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dist_train_writes_per_process_dirs_resumes_bitwise_and_jax_restores(
        tmp_path, data, case):  # noqa: F811 — the fixture
    mesh, over = CASES[case]
    world = mesh[0] * mesh[1]
    base = dict(data_parallel=mesh[0], row_parallel=mesh[1], save_every_epochs=1,
                epoch_num=2, checkpoint_format="orbax", **over)
    whole = _kw(tmp_path, data, "whole", model_file=str(tmp_path / "whole.orbax"), **base)
    cut = _kw(tmp_path, data, "cut", model_file=str(tmp_path / "cut.orbax"), **base)
    twin = _kw(tmp_path, data, "twin", **dict(base, checkpoint_format="npz"))
    _spawn(tmp_path, world, _job, [(whole, False, None), (twin, False, None),
                                   (cut, False, 8)])
    # Each row shard in its own process database; rank 0 writes the rest.
    parts = sorted(p for p in os.listdir(whole["model_file"]) if p.startswith("ocdbt.process_"))
    assert parts == [f"ocdbt.process_{r}" for r in range(mesh[1])]
    assert latest_step(cut["model_file"]) == 8
    cursor = read_input_cursor(cut["model_file"])
    assert cursor["process_count"] == world
    assert [(h["epoch"], h["batch_in_epoch"]) for h in cursor["hosts"]] == [(0, 8)] * world
    logs = _spawn(tmp_path, world, _job, [(cut, True, None)])
    a, b, c = _restored(whole["model_file"]), _restored(cut["model_file"]), _restored(twin[
        "model_file"])
    assert a.step == 40
    _same(a, b)
    _same(a, c)
    # The stopped run's losses and the resumed run's are the uninterrupted
    # run's (the stop at 8 saves before its log point).
    want, got = _losses(whole["metrics_path"]), _losses(cut["metrics_path"])
    assert set(want) - set(got) <= {8} and all(want[s] == v for s, v in got.items())
    # Each rank read the one chunk of its own rows.
    shard_rows = a.table.shape[0] // mesh[1]
    for rank, rank_logs in enumerate(logs):
        r = rank % mesh[1]
        want = (f"restored rows [{r * shard_rows}, {(r + 1) * shard_rows}) of "
                f"{cut['model_file']}: table chunks ['table/{r}.0']")
        assert any(line.startswith(want) for line in rank_logs[0]), (rank, rank_logs[0][:6])
    # The JAX package restores the per-process directory bitwise.
    like = jax_init_state(JaxFM(vocabulary_size=a.table.shape[0], factor_num=K),
                          jax.random.key(0))
    j = jax_restore(whole["model_file"], like)
    assert int(j.step) == a.step
    assert np.array_equal(np.asarray(j.table), a.table.numpy())
    assert np.array_equal(np.asarray(j.table_opt.accum), a.table_accum.numpy())
    if case == "2x2-rows":
        _spawn(tmp_path, world, _predict_job, [whole, twin])
        assert open(whole["score_path"]).read() == open(twin["score_path"]).read()


def test_a_jax_mesh_save_resumes_on_two_ranks_reading_only_their_chunks(tmp_path, data):  # noqa: F811
    """JAX saves its 2 x 2 mesh state (row chunks of V/4) as orbax and as
    npz; two port ranks at (1, 2) resume from each and end bitwise; every
    rank reads the two chunks of its half."""
    rng = np.random.default_rng(3)
    st = jax_init_state(JaxFM(vocabulary_size=V, factor_num=K), jax.random.key(0))
    st = st._replace(table=jnp.asarray(rng.uniform(-0.3, 0.3, (V, K + 1)).astype(np.float32)),
                     step=jnp.asarray(4, jnp.int32))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "row"))
    rows = NamedSharding(mesh, PartitionSpec("row", None))
    placed = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, PartitionSpec())), st)
    placed = placed._replace(table=jax.device_put(st.table, rows),
                             table_opt=placed.table_opt._replace(
                                 accum=jax.device_put(st.table_opt.accum, rows)))
    base = dict(data_parallel=1, row_parallel=2, epoch_num=1)
    a = _kw(tmp_path, data, "a", model_file=str(tmp_path / "a.orbax"), **base)
    b = _kw(tmp_path, data, "b", **base)
    jax_save(a["model_file"], placed, "orbax")
    jax_save(b["model_file"], st, "npz")
    logs = _spawn(tmp_path, 2, _job, [(a, True, None), (b, True, None)])
    half = V // 2
    for rank, rank_logs in enumerate(logs):
        want = (f"restored rows [{rank * half}, {(rank + 1) * half}) of {a['model_file']}: "
                f"table chunks ['table/{2 * rank}.0', 'table/{2 * rank + 1}.0']")
        assert any(line.startswith(want) for line in rank_logs[0]), rank_logs[0][:6]
    _same(_restored(a["model_file"]), _restored(b["model_file"]))
    assert _losses(a["metrics_path"]) == _losses(b["metrics_path"])
    # Another row count pads the vocabulary otherwise: refused with the remedy.
    wide = dict(a, vocabulary_size=V - 3, model_file=str(tmp_path / "w.orbax"))
    jax_save(wide["model_file"], st._replace(
        table=st.table[:V - 1], table_opt=st.table_opt._replace(accum=st.table_opt.accum[:V - 1])),
        "orbax")
    with pytest.raises(AssertionError, match="matching padded vocab"):
        _spawn(tmp_path, 2, _job, [(wide, True, None)])


# -- a real two-process pod ------------------------------------------------------

POD_ROWS, POD_BATCH, POD_EPOCHS = 320, 64, 4  # 5 steps an epoch, epoch saves at 5, 10, 15


def _pod_cfg(tmp):
    cfg = tmp / "run.cfg"
    cfg.write_text(f"""
[General]
model = fm
factor_num = 4
vocabulary_size = 64
model_file = {tmp}/m.orbax
checkpoint_format = orbax

[Train]
train_files = {tmp}/t.libsvm
epoch_num = {POD_EPOCHS}
batch_size = {POD_BATCH}
max_nnz = 4
learning_rate = 0.1
log_every = 1
metrics_path = {tmp}/run.jsonl

[Resilience]
restart_backoff_s = 0.2

[Distributed]
num_processes = 2
barrier_timeout_s = 60
""")
    rng = np.random.default_rng(7)
    lines = []
    for _ in range(POD_ROWS):
        ids = rng.choice(64, size=4, replace=False)
        lines.append(f"{rng.integers(0, 2)} " + " ".join(f"{i}:1.0" for i in ids))
    (tmp / "t.libsvm").write_text("\n".join(lines) + "\n")
    return str(cfg)


def _pod(tmp, *args):
    cmd = [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "dist_train", _pod_cfg(tmp),
           "--supervised", "--device", "cpu", *args]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stdout[-6000:]
    return proc.stdout


def test_a_supervised_orbax_pod_resumes_from_its_directory_after_kill_at_8(tmp_path):
    clean, chaos = tmp_path / "clean", tmp_path / "chaos"
    clean.mkdir()
    chaos.mkdir()
    _pod(clean)
    out = _pod(chaos, "--fault-plan", "kill@8", "--fault-process", "1", "--max-restarts", "3")
    assert "launch host 1 attempt 1 gen 1 (resume)" in out
    assert f"resumed from {chaos}/m.orbax at step 5" in out
    steps = POD_ROWS // POD_BATCH * POD_EPOCHS
    want, got = _losses(clean / "run.jsonl"), _losses(chaos / "run.jsonl")
    assert len(want) == steps and got == want
    a = restore_checkpoint(str(clean / "m.orbax"), CPU, accum_width=5)
    b = restore_checkpoint(str(chaos / "m.orbax"), CPU, accum_width=5)
    assert a.step == b.step == steps
    assert torch.equal(a.table, b.table) and torch.equal(a.table_accum, b.table_accum)
