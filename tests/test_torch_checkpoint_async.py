"""Port: async and delta checkpoints, against the JAX package, on the CPU.

* Delta chains cross between the packages: a chain the JAX package wrote
  (its ``save_delta`` and its ``train`` with ``delta_every_steps``)
  restores in the port bitwise equal to the JAX restore, and a chain the
  port wrote restores in the JAX package bitwise equal to the port's.
* A port run with ``async_save`` and ``delta_every_steps`` ends bitwise
  equal to its synchronous run on the rows, packed element, packed row and
  fused layouts, streamed and device-cached (K = 1 and 8); a mid-run base +
  chain replays bitwise to the synchronous save of the same step; a run
  resumed from a chain head ends bitwise equal to the uninterrupted run.
* The JAX tests of tests/test_checkpoint_async.py where the port has a
  counterpart: compaction by ``delta_chain_max``, a failed write promotes
  the next boundary to a full save, a torn or half-written delta and a
  broken chain fail with the JAX errors, a full save resets the chain,
  glob metacharacters, ``read_input_cursor`` of the chain head, the config
  checks, and tools/report.py's checkpoint section.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import checkpoint_save_id as jax_checkpoint_save_id
from fast_tffm_tpu.checkpoint import read_delta_chain as jax_read_delta_chain
from fast_tffm_tpu.checkpoint import read_input_cursor as jax_read_input_cursor
from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore_checkpoint
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.checkpoint import save_delta as jax_save_delta
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch import checkpoint as ckpt_mod
from fast_tffm_tpu_torch import checkpoint_async
from fast_tffm_tpu_torch.checkpoint import (
    checkpoint_save_id,
    checkpoint_signature,
    delta_paths,
    latest_step,
    read_delta_chain,
    read_input_cursor,
    read_publish_time,
    restore_checkpoint,
    save_checkpoint,
    save_delta,
)
from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer, gather_rows
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.telemetry import SCHEMAS
from fast_tffm_tpu_torch.trainer import TrainState, pack_state
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20
CPU = torch.device("cpu")

LAYOUT_KW = {
    "rows": dict(adagrad_accumulator="element"),
    "element": dict(table_layout="packed", adagrad_accumulator="element"),
    "row": dict(table_layout="packed", adagrad_accumulator="row"),
    "fused": dict(table_layout="packed", adagrad_accumulator="fused"),
}


def quiet(*_):
    pass


class _Abort(Exception):
    """A mid-run abort: the run skips its final save, so the files on disk
    are the ones the boundary under test published."""


def _abort_at(n):
    def hook(step):
        if step >= n:
            raise _Abort()

    return hook


def _jax_cfg(**kw):
    return JaxConfig(telemetry_profile_costs=False, **kw).validate()


def _kw(tmp_path, name, **kw):
    for src in (TRAIN, TEST):
        if not (tmp_path / os.path.basename(src)).exists():
            shutil.copy(src, tmp_path)
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        epoch_num=2, batch_size=B, learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4,
        log_every=5, thread_num=2,
    )
    base.update(kw)
    return base


def _shared_npz(path, accumulator="element", seed=0):
    """A seeded [V, 1+K] table, accumulators at 0.1, saved by the JAX package."""
    width = "row" if accumulator in ("row", "fused") else "element"
    jcfg = _jax_cfg(model="fm", order=3, factor_num=K, vocabulary_size=V,
                    adagrad_accumulator=width)
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, width)
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _port_cfg(tmp_path, name, layout="rows", init=None, **kw):
    cfg = Config(**_kw(tmp_path, name, **LAYOUT_KW[layout], **kw)).validate()
    if init is not None:
        shutil.copy(init, cfg.model_file)
    return cfg


def _width(layout):
    return 1 + K if LAYOUT_KW[layout]["adagrad_accumulator"] == "element" else 1


def _restored(path, width):
    return restore_checkpoint(path, CPU, accum_width=width)


def _assert_same(a: TrainState, b: TrainState):
    assert a.step == b.step
    assert torch.equal(a.table, b.table)
    assert torch.equal(a.table_accum, b.table_accum)


def _jax_restore(path, accumulator):
    jcfg = _jax_cfg(model="fm", order=3, factor_num=K, vocabulary_size=V,
                    adagrad_accumulator=accumulator)
    like = jax_init_state(jax_build_model(jcfg), jax.random.key(9), 0.1, accumulator)
    return jax_restore_checkpoint(path, like)


def _records(path, kind):
    return [r for r in map(json.loads, open(path)) if r["kind"] == kind]


# --- chains across the packages -------------------------------------------------


def _jax_chain(path):
    """A base and two deltas written by the JAX package's own functions."""
    jcfg = _jax_cfg(model="fm", order=3, factor_num=K, vocabulary_size=V)
    st = jax_init_state(jax_build_model(jcfg), jax.random.key(3), 0.1, "element")
    jax_save_checkpoint(path, st._replace(step=st.step + 2), "npz",
                        cursor={"version": 1, "epoch": 0, "batch_in_epoch": 2})
    rng = np.random.default_rng(4)
    parent = jax_checkpoint_save_id(path)
    for seq, rows in ((1, [1, 7, 200]), (2, [7, 9])):
        out, parent, _ = jax_save_delta(
            path, seq, idx=np.array(rows),
            table_rows=rng.normal(size=(len(rows), 1 + K)).astype(np.float32),
            accum_rows=rng.uniform(0.1, 1, size=(len(rows), 1 + K)).astype(np.float32),
            dense_leaves=[], dense_accum_leaves=[], step=np.int32(2 + 3 * seq),
            parent_sig=parent, cursor={"version": 1, "epoch": 0, "batch_in_epoch": 2 + 3 * seq},
        )


def test_a_jax_written_chain_restores_bitwise_in_the_port(tmp_path):
    path = str(tmp_path / "j.ckpt")
    _jax_chain(path)
    want = _jax_restore(path, "element")
    got = _restored(path, 1 + K)
    assert got.step == int(want.step) == 8
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.table_accum.numpy(), np.asarray(want.table_opt.accum))
    assert read_input_cursor(path) == jax_read_input_cursor(path) == {
        "version": 1, "epoch": 0, "batch_in_epoch": 8}
    assert read_delta_chain(path) == jax_read_delta_chain(path)
    assert checkpoint_save_id(path) == jax_checkpoint_save_id(path)
    assert latest_step(path) == 8 and read_publish_time(path) is not None


@pytest.mark.parametrize("layout", ["rows", "fused"])
def test_a_jax_training_chain_restores_in_the_port_and_back(tmp_path, layout):
    """The JAX trainer with delta_every_steps = 3, aborted at step 8, leaves
    base@3 + delta@6; the port restores it bitwise equal to the JAX restore.
    Then the port trains the same way and the JAX package restores the
    port's chain bitwise equal to the port's restore."""
    acc = LAYOUT_KW[layout]["adagrad_accumulator"]
    logical = "row" if acc == "fused" else acc
    _shared_npz(tmp_path / "init.ckpt", acc)
    kw = _kw(tmp_path, "jax.ckpt", **LAYOUT_KW[layout], delta_every_steps=3)
    shutil.copy(tmp_path / "init.ckpt", kw["model_file"])
    with pytest.raises(_Abort):
        jax_train(_jax_cfg(**kw), resume=True, log=quiet, step_hook=_abort_at(8))
    assert [os.path.basename(p) for p in delta_paths(kw["model_file"])] == [
        "jax.ckpt.delta-0001.npz"]
    want = _jax_restore(kw["model_file"], logical)
    got = _restored(kw["model_file"], _width(layout))
    assert got.step == int(want.step) == 6
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.table_accum.numpy(), np.asarray(want.table_opt.accum))

    cfg = _port_cfg(tmp_path, "port.ckpt", layout, tmp_path / "init.ckpt", delta_every_steps=3)
    with pytest.raises(_Abort):
        train(cfg, resume=True, log=quiet, device="cpu", step_hook=_abort_at(8))
    assert len(delta_paths(cfg.model_file)) == 1
    mine = _restored(cfg.model_file, _width(layout))
    theirs = _jax_restore(cfg.model_file, logical)
    assert mine.step == int(theirs.step) == 6
    np.testing.assert_array_equal(mine.table.numpy(), np.asarray(theirs.table))
    np.testing.assert_array_equal(mine.table_accum.numpy(), np.asarray(theirs.table_opt.accum))
    # The two trainers agree within the tolerance they are held to.
    np.testing.assert_allclose(mine.table.numpy(), got.table.numpy(), atol=1e-5)
    assert read_input_cursor(cfg.model_file) == jax_read_input_cursor(kw["model_file"])


# --- the port's async and delta runs against its sync runs ------------------------


STREAMED = [
    ("rows", dict()),
    ("element", dict(binary_cache=True, shuffle=True, shuffle_seed=5)),
    ("row", dict(binary_cache=True, shuffle=True, shuffle_seed=5)),
    ("fused", dict(binary_cache=True, shuffle=True, shuffle_seed=5)),
    ("rows", dict(steps_per_call=4)),
    ("rows", dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5)),
    ("fused", dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5,
                   steps_per_call=8)),
    ("rows", dict(device_cache=True, binary_cache=True, steps_per_call=8)),
]


def _case_id(case):
    layout, mode = case
    src = "cached" if mode.get("device_cache") else "fmb" if mode.get("binary_cache") else "text"
    return f"{src}-K{mode.get('steps_per_call', 1)}-{layout}"


@pytest.mark.parametrize("case", STREAMED, ids=_case_id)
def test_async_and_delta_runs_are_bitwise_the_sync_run(tmp_path, case):
    layout, mode = case
    _shared_npz(tmp_path / "init.ckpt", LAYOUT_KW[layout]["adagrad_accumulator"])
    init = tmp_path / "init.ckpt"
    sync = _port_cfg(tmp_path, "sync.ckpt", layout, init, **mode)
    fast = _port_cfg(tmp_path, "fast.ckpt", layout, init, async_save=True, delta_every_steps=8,
                     metrics_path=str(tmp_path / "m.jsonl"), **mode)
    a = train(sync, resume=True, log=quiet, device="cpu")
    b = train(fast, resume=True, log=quiet, device="cpu")
    assert a.step == b.step == 40
    w = _width(layout)
    _assert_same(_restored(fast.model_file, w), _restored(sync.model_file, w))
    assert delta_paths(fast.model_file) == []  # the final full save reset the chain
    assert read_input_cursor(fast.model_file) == read_input_cursor(sync.model_file)
    ckpt = _records(fast.metrics_path, "ckpt")
    assert {r["mode"] for r in ckpt} == {"full", "delta"}
    for r in ckpt:
        assert all(k in r for k in SCHEMAS["ckpt"])
    (summary,) = _records(fast.metrics_path, "summary")
    assert summary["ckpt_delta_saves"] >= 2 and summary["steady_compiles"] == 0


@pytest.mark.parametrize("layout", ["rows", "element", "row", "fused"])
def test_a_mid_run_chain_replays_to_the_sync_save_of_its_step(tmp_path, layout):
    """The delta run aborts at step 8 (base@3 + delta@6); the sync run
    stops by SIGTERM at 6: both files restore to the same bits."""
    import signal

    _shared_npz(tmp_path / "init.ckpt", LAYOUT_KW[layout]["adagrad_accumulator"])
    init = tmp_path / "init.ckpt"
    delta = _port_cfg(tmp_path, "delta.ckpt", layout, init, delta_every_steps=3)
    with pytest.raises(_Abort):
        train(delta, resume=True, log=quiet, device="cpu", step_hook=_abort_at(8))
    assert latest_step(delta.model_file) == 6 and len(delta_paths(delta.model_file)) == 1
    sync = _port_cfg(tmp_path, "sync.ckpt", layout, init)
    fired = []

    def stop_at_6(step):
        if step >= 6 and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    train(sync, resume=True, log=quiet, device="cpu", step_hook=stop_at_6)
    w = _width(layout)
    _assert_same(_restored(delta.model_file, w), _restored(sync.model_file, w))
    assert read_input_cursor(delta.model_file) == read_input_cursor(sync.model_file)


@pytest.mark.parametrize("k", [1, 8])
def test_a_run_resumed_from_a_chain_head_is_bitwise_the_uninterrupted_run(tmp_path, k):
    """delta_every_steps = 8, aborted at the call that reaches step 18: the
    files are base@8 + delta@16 and the chain head names its cursor (0,
    16); --resume replays the chain and ends bitwise equal to the run that
    was never stopped."""
    mode = dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5,
                steps_per_call=k) if k > 1 else {}
    _shared_npz(tmp_path / "init.ckpt")
    init = tmp_path / "init.ckpt"
    whole = _port_cfg(tmp_path, "whole.ckpt", "rows", init, delta_every_steps=8, **mode)
    cut = _port_cfg(tmp_path, "cut.ckpt", "rows", init, delta_every_steps=8, **mode)
    want = train(whole, resume=True, log=quiet, device="cpu")
    with pytest.raises(_Abort):
        train(cut, resume=True, log=quiet, device="cpu", step_hook=_abort_at(18))
    assert latest_step(cut.model_file) == 16 and len(delta_paths(cut.model_file)) == 1
    assert read_input_cursor(cut.model_file)["batch_in_epoch"] == 16
    log = []
    got = train(cut, resume=True, log=log.append, device="cpu")
    assert "resuming input at epoch 0, batch 16 (exact-position cursor)" in log
    _assert_same(got, want)
    _assert_same(_restored(cut.model_file, 1 + K), _restored(whole.model_file, 1 + K))


def test_a_resumed_run_extends_the_chain_it_restored(tmp_path):
    """A run resumed from base@4 + deltas @8, @12 keeps the chain: its first
    delta boundary writes delta-0003 chained to delta-0002."""
    _shared_npz(tmp_path / "init.ckpt")
    cfg = _port_cfg(tmp_path, "m.ckpt", "rows", tmp_path / "init.ckpt", delta_every_steps=4)
    with pytest.raises(_Abort):
        train(cfg, resume=True, log=quiet, device="cpu", step_hook=_abort_at(14))
    assert [m["step"] for m in read_delta_chain(cfg.model_file)[1]] == [8, 12]
    with pytest.raises(_Abort):
        train(cfg, resume=True, log=quiet, device="cpu", step_hook=_abort_at(17))
    chain = read_delta_chain(cfg.model_file)[1]
    assert [m["step"] for m in chain] == [8, 12, 16]
    assert [os.path.basename(m["path"]) for m in chain][-1] == "m.ckpt.delta-0003.npz"


# --- the checkpointer alone -------------------------------------------------------


def _small_state(v=128, d=5, bump=0.0, step=0):
    rng = np.random.default_rng(11)
    return TrainState(
        table=torch.from_numpy(rng.uniform(-1, 1, (v, d)).astype(np.float32) + bump),
        dense=[], step=step, table_accum=torch.full((v, d), 0.1),
    )


def _ident(s):
    return s


def test_delta_chain_max_promotes_to_full(tmp_path):
    path = str(tmp_path / "m.ckpt")
    ck = AsyncCheckpointer(path, device=CPU, delta_every_steps=1, delta_chain_max=2,
                           vocab=128, row_dim=5, log=quiet)
    st = _small_state()
    ck.save_boundary(st, _ident, 0, sync=True, emit=False)
    for step in (1, 2, 3):
        ck.note_batch(torch.tensor([[1, 2, 3]]))
        ck.delta_boundary(dataclasses.replace(st, step=step), _ident, step)
        ck.finalize()
        if step < 3:
            assert len(delta_paths(path)) == step
    # Boundaries 1 and 2 wrote deltas; boundary 3 hit the cap: a full save.
    assert delta_paths(path) == [] and ck.delta_saves == 2 and latest_step(path) == 3


def test_failed_write_forces_full_promotion(tmp_path, monkeypatch):
    path = str(tmp_path / "m.ckpt")
    ck = AsyncCheckpointer(path, device=CPU, delta_every_steps=1, vocab=128, row_dim=5,
                           log=quiet)
    st = _small_state()
    ck.save_boundary(st, _ident, 0, sync=True, emit=False)  # the signed base
    st1 = dataclasses.replace(st, table=st.table.clone(), step=1)
    st1.table[3] += 5.0
    ck.note_batch(torch.tensor([[3]]))

    def boom(*a, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(checkpoint_async, "save_delta", boom)
    ck.delta_boundary(st1, _ident, 1)
    ck.finalize()
    monkeypatch.undo()
    assert ck.write_failures == 1
    assert torch.equal(_restored(path, 5).table, st.table)  # the base as it was
    st2 = dataclasses.replace(st1, table=st1.table.clone(), step=2)
    st2.table[9] += 2.0
    ck.note_batch(torch.tensor([[9]]))
    ck.delta_boundary(st2, _ident, 2)  # must promote: row 3's update is in no delta
    ck.finalize()
    assert ck.delta_saves == 0 and ck.sync_saves == 2 and delta_paths(path) == []
    assert torch.equal(_restored(path, 5).table, st2.table)


def test_async_write_failure_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state(bump=1.0, step=1))
    ck = AsyncCheckpointer(path, device=CPU, async_save=True, log=quiet)

    def boom(*a, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt_mod, "_write_npz_streaming", boom)
    ck.save_boundary(_small_state(bump=2.0, step=2), _ident, 2)
    ck.finalize()
    monkeypatch.undo()
    assert ck.write_failures == 1
    r = _restored(path, 5)
    assert r.step == 1 and torch.equal(r.table, _small_state(bump=1.0).table)


def test_the_async_snapshot_is_taken_at_the_boundary(tmp_path):
    """The loop changes the live table right after an async boundary; the
    file holds the boundary's values."""
    path = str(tmp_path / "m.ckpt")
    ck = AsyncCheckpointer(path, device=CPU, async_save=True, log=quiet)
    st = _small_state(step=4)
    want = st.table.clone()
    ck.save_boundary(st, _ident, 4)
    st.table.add_(1.0)  # the next step, in place
    ck.finalize()
    assert torch.equal(_restored(path, 5).table, want)


@pytest.mark.parametrize("layout", ["packed", "fused"])
def test_row_gather_reads_the_logical_rows_of_every_layout(layout):
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(size=(300, 9)).astype(np.float32))
    accum = torch.from_numpy(rng.uniform(0.1, 1, (300, 9 if layout == "packed" else 1))
                             .astype(np.float32))
    st = TrainState(table=table, dense=[], step=0, table_accum=accum)
    idx = torch.tensor([0, 5, 13, 14, 299])
    rows, acc = gather_rows(pack_state(st, 0.1, fused=layout == "fused"), idx, 9)
    assert torch.equal(rows, table[idx]) and torch.equal(acc, accum[idx])


def _delta(path, seq, parent, rows=(2,), value=7.0, step=5):
    return save_delta(path, seq, idx=np.array(rows), dense_leaves=[], dense_accum_leaves=[],
                      table_rows=np.full((len(rows), 5), value, np.float32),
                      accum_rows=np.full((len(rows), 5), value, np.float32),
                      step=step, parent_sig=parent)


def test_delta_paths_glob_metacharacters(tmp_path):
    d = tmp_path / "run[1]"
    d.mkdir()
    path = str(d / "m.ckpt")
    save_checkpoint(path, _small_state(bump=0.5))
    _delta(path, 1, checkpoint_save_id(path))
    assert len(delta_paths(path)) == 1
    r = _restored(path, 5)
    assert r.step == 5 and torch.equal(r.table[2], torch.full((5,), 7.0))


def test_half_written_delta_fails_naming_file(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    with open(path + ".delta-0001.npz", "wb") as f:
        f.write(b"not an npz at all")
    with pytest.raises(ValueError, match="delta-0001") as e:
        _restored(path, 5)
    with pytest.raises(ValueError) as je:
        jax_read_delta_chain(path)
    assert str(e.value) == str(je.value)


def test_torn_delta_member_fails_naming_file(tmp_path):
    """A delta cut short inside its rows: the JAX error, word for word."""
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    dp, _, _ = _delta(path, 1, checkpoint_save_id(path), rows=tuple(range(100)))
    raw = open(dp, "rb").read()
    with open(dp, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="delta-0001") as e:
        _restored(path, 5)
    with pytest.raises(ValueError) as je:
        jax_read_delta_chain(path)
    assert str(e.value) == str(je.value)


def test_broken_chain_fails_loudly(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    _delta(path, 1, "deadbeef" * 4, step=9)
    with pytest.raises(ValueError, match="does not chain") as e:
        _restored(path, 5)
    with pytest.raises(ValueError) as je:
        jax_read_delta_chain(path)
    assert str(e.value) == str(je.value)


def test_full_save_resets_stale_chain(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    _delta(path, 1, checkpoint_save_id(path))
    sig_before = checkpoint_signature(path)
    save_checkpoint(path, _small_state(step=9))
    assert delta_paths(path) == [] and latest_step(path) == 9
    assert checkpoint_signature(path) != sig_before


def test_a_delta_of_the_other_granularity_is_refused(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    save_delta(path, 1, idx=np.array([1]), table_rows=np.ones((1, 5), np.float32),
               accum_rows=np.ones((1, 1), np.float32), dense_leaves=[], dense_accum_leaves=[],
               step=3, parent_sig=checkpoint_save_id(path))
    with pytest.raises(ValueError, match="adagrad_accumulator"):
        _restored(path, 5)
    assert restore_checkpoint(path, CPU).step == 3  # scoring reads the table alone


def test_chunked_staging_writes_the_same_members(tmp_path):
    """A save in 512-byte chunks holds the state's exact bytes (the staging
    buffer serves CUDA tensors only; a CPU state streams without it)."""
    st = _small_state(v=333, d=7, bump=0.25)
    path = str(tmp_path / "m.ckpt")
    timings = {}
    save_checkpoint(path, st, chunk_bytes=512, timings=timings,
                    staging=torch.empty(512, dtype=torch.uint8))
    assert set(timings) == {"d2h_ms", "write_ms"}
    with np.load(path) as z:
        np.testing.assert_array_equal(z["table"], st.table.numpy())
        np.testing.assert_array_equal(z["table_accum"], st.table_accum.numpy())


@pytest.mark.parametrize(
    "kw,needle",
    [
        (dict(delta_chain_max=0), "delta_chain_max"),
        (dict(checkpoint_chunk_mb=0), "checkpoint_chunk_mb"),
        (dict(delta_full_every_s=-1), "full_every_s"),
        (dict(delta_chain_max_bytes=-1), "chain_max_bytes"),
        (dict(delta_every_steps=4, online_accum_restart_steps=10), "accum_restart_steps"),
    ],
)
def test_delta_config_validation_matches_jax(kw, needle):
    with pytest.raises(ValueError, match=needle) as e:
        Config(**kw).validate()
    with pytest.raises(ValueError) as je:
        JaxConfig(**kw).validate()
    assert str(e.value) == str(je.value)


def test_report_renders_a_port_runs_checkpoint_section(tmp_path):
    _shared_npz(tmp_path / "init.ckpt")
    cfg = _port_cfg(tmp_path, "m.ckpt", "rows", tmp_path / "init.ckpt", async_save=True,
                    delta_every_steps=8, metrics_path=str(tmp_path / "m.jsonl"))
    train(cfg, resume=True, log=quiet, device="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "report.py"),
                        cfg.metrics_path], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "## Checkpointing" in r.stdout
