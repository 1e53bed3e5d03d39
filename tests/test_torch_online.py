"""Port: online learning against the JAX package, on the CPU
(tests/test_online.py's cases).

* The FMS container: the port's ``StreamWriter`` and the JAX one write
  byte-identical files for the same rows (whole and torn appends), each
  package reads the other's file, a torn trailing record never counts, and
  the prefix fingerprints are equal.
* ``fms_follow_stream``: the port's batches equal the JAX reader's over
  the same file, with ``skip_batches``, ``max_batches``, a wider
  ``max_nnz``, the idle timeout and ``stop``; it follows growth, marks
  itself idle, and detects truncation and replacement as the JAX reader
  does.
* Follow ``train`` from one shared npz: the port's losses within rtol
  1e-5 and its final arrays within atol 1e-5 of the JAX run's (the
  tolerance of tests/test_torch_training.py), at K = 1, 4 and 8 (K = 8
  with a stream that ends mid-group); the saved cursor is the JAX run's
  (``follow`` true, the prefix fingerprint).  A mid-stream resume over a
  grown file is bitwise one uninterrupted run; a changed prefix fails
  loudly; a SIGTERM to ``cli train`` while the stream is idle saves and
  exits 0, and its resume ends bitwise.
* ``accum_restart_steps``: ``make_accum_restart`` fills every accumulator
  with the init value in place (rows and packed element/row); a run
  matches the JAX run, and K = 1 and K = 4 are bitwise equal.
* The config rejects the online combinations the JAX config rejects, with
  its messages; ``scan_max_nnz`` takes an FMS file's header width.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import read_input_cursor as jax_read_input_cursor
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.data import stream as jax_stream
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import scan_max_nnz as jax_scan_max_nnz
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import read_input_cursor, restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model, load_config
from fast_tffm_tpu_torch.data import stream
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.trainer import (
    init_packed_state,
    init_state,
    make_accum_restart,
    make_train_step,
    unpack_state,
)
from fast_tffm_tpu_torch.training import train
from fast_tffm_tpu_torch.utils.prefetch import InputStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, W, B, K = 256, 6, 32, 8
CPU = torch.device("cpu")


def quiet(*_):
    pass


def _rows(rng, n, vocab=V, width=W):
    """n rows of ``width`` slots, 2..width of them filled."""
    nnz = rng.integers(2, width + 1, size=n)
    ids = rng.integers(0, vocab, size=(n, width))
    vals = np.round(np.abs(rng.normal(size=(n, width))) + 0.1, 4).astype(np.float32)
    mask = np.arange(width)[None, :] < nnz[:, None]
    return (rng.integers(0, 2, size=n), np.where(mask, ids, 0), np.where(mask, vals, 0),
            nnz)


def _write(mod, path, data, torn_at=None):
    """``data`` appended batch by batch with ``mod``'s writer; the append
    ``torn_at`` (1-based) torn and completed by the next one."""
    w = mod.StreamWriter(path, width=W, vocabulary_size=V)
    for n, (l, i, v, z) in enumerate(data, 1):
        (w.append_torn if n == torn_at else w.append)(l, i, v, nnz=z)
    w.close()
    return path


def _data(seed, batches):
    rng = np.random.default_rng(seed)
    return [_rows(rng, B) for _ in range(batches)]


# --- the container ------------------------------------------------------------


@pytest.mark.parametrize("torn_at", [None, 2], ids=["whole", "torn"])
def test_writers_write_byte_identical_files_and_each_reads_the_others(tmp_path, torn_at):
    data = _data(1, 3)
    mine = _write(stream, str(tmp_path / "port.fms"), data, torn_at)
    theirs = _write(jax_stream, str(tmp_path / "jax.fms"), data, torn_at)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert stream.read_fms_header(theirs) == dict(jax_stream.read_fms_header(theirs),
                                                  path=theirs)
    for reader, path in ((stream, theirs), (jax_stream, mine)):
        got = reader.read_fms_rows(path, B, B)
        l, i, v, z = data[1]
        np.testing.assert_array_equal(got[0], l.astype(np.float32))
        np.testing.assert_array_equal(got[1], z)
        np.testing.assert_array_equal(got[2], i)
        np.testing.assert_array_equal(got[3], v)
    assert stream.fms_row_count(mine, W) == jax_stream.fms_row_count(mine, W) == 3 * B
    assert stream.is_fms(theirs) and jax_stream.is_fms(mine)


def test_a_torn_trailing_record_never_counts(tmp_path):
    p = str(tmp_path / "s.fms")
    data = _data(2, 2)
    w = stream.StreamWriter(p, width=W, vocabulary_size=V)
    w.append(*data[0][:3], nnz=data[0][3])
    w.append_torn(*data[1][:3], nnz=data[1][3])
    size = os.path.getsize(p)
    assert (size - stream.FMS_HEADER_BYTES) % stream.fms_record_bytes(W)  # a partial record
    for mod in (stream, jax_stream):
        assert mod.fms_row_count(p, W) == 2 * B - 1
    w.complete_torn()
    for mod in (stream, jax_stream):
        assert mod.fms_row_count(p, W) == 2 * B
    w.close()


def test_writer_refusals_match_jax(tmp_path):
    p = str(tmp_path / "s.fms")
    for mod in (stream, jax_stream):
        w = mod.StreamWriter(p, width=W, vocabulary_size=V)
        with pytest.raises(ValueError, match=r"id out of \[0, 256\)"):
            w.append([1], [[V]], [[1.0]], nnz=[1])
        w.close()
        with pytest.raises(ValueError, match="existing stream has width"):
            mod.StreamWriter(p, width=W + 1, vocabulary_size=V)
    _write(stream, str(tmp_path / "ok.fms"), _data(3, 1))
    shutil.copy(str(tmp_path / "ok.fms"), p)
    with open(p, "r+b") as f:  # a complete record with an impossible nnz
        f.seek(stream.FMS_HEADER_BYTES + 4)
        f.write(np.int32(99).tobytes())
    for mod in (stream, jax_stream):
        with pytest.raises(ValueError, match="corrupt stream record at row 0"):
            mod.read_fms_rows(p, 0, 1)


def test_prefix_fingerprints_equal_jax_and_survive_appends(tmp_path):
    p = _write(stream, str(tmp_path / "s.fms"), _data(4, 2))
    fp = stream.stream_prefix_fingerprint([p])
    assert fp == jax_stream.stream_prefix_fingerprint([p])
    big = _write(stream, str(tmp_path / "big.fms"), _data(5, 20))  # past the 64 KiB window
    assert stream.stream_prefix_fingerprint([big, p]) == jax_stream.stream_prefix_fingerprint(
        [big, p])
    _write(stream, p, _data(6, 1))  # an append
    assert stream.stream_prefix_matches([p], fp) and jax_stream.stream_prefix_matches([p], fp)
    os.remove(p)
    _write(stream, p, _data(7, 3))  # a replacement
    for mod in (stream, jax_stream):
        assert not mod.stream_prefix_matches([p], fp)
        assert not mod.stream_prefix_matches([p], "0123456789abcdef")
        assert not mod.stream_prefix_matches([p, p], fp)


# --- the follow reader --------------------------------------------------------


def _equal_batches(got, want):
    assert len(got) == len(want)
    for (p, w), (q, x) in zip(got, want):
        for f in ("labels", "ids", "vals", "fields", "nnz"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f), err_msg=f)
        np.testing.assert_array_equal(w, x)


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_batches=5),
        dict(max_batches=5, skip_batches=2),
        dict(max_batches=4, max_nnz=W + 3),
        dict(idle_timeout_s=0.1),
        dict(idle_timeout_s=0.1, skip_batches=3, weight=0.5),
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_follow_batches_equal_the_jax_readers(tmp_path, kw):
    p = _write(stream, str(tmp_path / "s.fms"), _data(8, 5))
    with open(p, "ab") as f:  # half a batch and a partial record stay unread
        f.write(b"\0" * (stream.fms_record_bytes(W) * (B // 2) + 7))
    common = dict(batch_size=B, vocabulary_size=V, poll_s=0.01, **kw)
    got = list(stream.fms_follow_stream(p, **common))
    want = list(jax_stream.fms_follow_stream(p, **common))
    _equal_batches(got, want)
    assert len(got) == 5 - kw.get("skip_batches", 0) - (1 if kw.get("max_batches") == 4 else 0)


def test_follow_stops_at_once_and_follows_growth_as_jax_does(tmp_path):
    p = _write(stream, str(tmp_path / "s.fms"), _data(9, 2))
    stop = threading.Event()
    stop.set()
    assert list(stream.fms_follow_stream(p, batch_size=B, vocabulary_size=V, poll_s=0.01,
                                         stop=stop)) == []
    idle, got = threading.Event(), []

    def consume():
        got.extend(stream.fms_follow_stream(p, batch_size=B, vocabulary_size=V, poll_s=0.01,
                                            max_batches=4, idle_flag=idle))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert idle.wait(10) and len(got) == 2  # idle-polling at EOF, not done
    tail = _data(10, 2)
    _write(stream, p, tail)
    t.join(10)
    assert not t.is_alive() and not idle.is_set()
    want = list(jax_stream.fms_follow_stream(p, batch_size=B, vocabulary_size=V, poll_s=0.01,
                                             max_batches=4))
    _equal_batches(got, want)
    np.testing.assert_array_equal(got[2][0].ids, tail[0][1])


@pytest.mark.parametrize("mod", [stream, jax_stream], ids=["port", "jax"])
def test_follow_detects_truncation_and_replacement(tmp_path, mod):
    p = _write(stream, str(tmp_path / "s.fms"), _data(11, 3))
    gen = mod.fms_follow_stream(p, batch_size=B, vocabulary_size=V, poll_s=0.01, max_batches=9)
    next(gen), next(gen)
    with open(p, "r+b") as f:
        f.truncate(stream.FMS_HEADER_BYTES + stream.fms_record_bytes(W) * B)
    with pytest.raises(ValueError, match="shrank"):
        list(gen)
    os.remove(p)
    _write(stream, p, _data(12, 2))
    gen = mod.fms_follow_stream(p, batch_size=B, vocabulary_size=V, poll_s=0.01, max_batches=9)
    next(gen), next(gen)
    os.remove(p)
    _write(stream, p, _data(13, 2))
    with pytest.raises(ValueError, match="PREFIX changed"):
        list(gen)


def test_a_starved_loop_on_an_idle_stream_classifies_stream_idle():
    """The monitor's watchdog reads the stream's idle probe, as the JAX
    RunMonitor's does (``set_stream_idle_fn``)."""
    stats, idle = InputStats(), threading.Event()
    stats.bind_stream_idle(idle)
    assert stats.stream_idle() is False
    idle.set()
    lines = []
    mon = RunMonitor(None, stall_timeout_s=0.2, log=lines.append)
    mon.set_queue_depth_fn(lambda: 0)
    mon.set_producer_alive_fn(lambda: True)
    mon.set_stream_idle_fn(stats.stream_idle)
    mon.heartbeat(3)
    deadline = time.monotonic() + 10
    while not lines and time.monotonic() < deadline:
        time.sleep(0.05)
    mon.close()
    assert lines and "input-starved (stream-idle)" in lines[0]


def test_scan_max_nnz_takes_the_fms_header_width(tmp_path):
    p = _write(stream, str(tmp_path / "s.fms"), _data(14, 1))
    kw = dict(model="fm", vocabulary_size=V, train_files=(p,), online_follow=True)
    assert scan_max_nnz(Config(**kw).validate()) == W
    assert jax_scan_max_nnz(JaxConfig(**kw).validate()) == W


# --- follow training --------------------------------------------------------


def _shared_npz(path, accumulator="element"):
    """A seeded [V, 1+K] table with accumulators at 0.1, saved by the JAX
    package without a cursor."""
    jcfg = JaxConfig(model="fm", order=3, factor_num=K, vocabulary_size=V,
                     telemetry_profile_costs=False, adagrad_accumulator=accumulator).validate()
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, accumulator)
    table = np.random.default_rng(0).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _follow_kw(tmp_path, fms, name, max_batches, **kw):
    base = dict(model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=W,
                model_file=str(tmp_path / name), train_files=(fms,), epoch_num=1,
                batch_size=B, learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4,
                log_every=2, online_follow=True, online_max_batches=max_batches,
                online_poll_s=0.02, online_idle_timeout_s=0.3,
                metrics_path=str(tmp_path / (name + ".jsonl")))
    base.update(kw)
    return base


def _start(tmp_path, name, init):
    shutil.copy(init, tmp_path / name)


def _train_records(path):
    return [r for r in map(json.loads, open(path)) if r.get("kind") == "train"]


@pytest.mark.parametrize("k,batches,max_batches", [(1, 6, 6), (4, 8, 8), (8, 12, 0)],
                         ids=["k1", "k4", "k8-idle-ends-mid-group"])
def test_follow_train_matches_jax(tmp_path, k, batches, max_batches):
    """K = 8 over 12 batches with no max_batches: the stream goes idle
    after the first group and the idle timeout ends the second group at 4
    batches, in both packages."""
    fms = _write(stream, str(tmp_path / "s.fms"), _data(20, batches))
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    kw = dict(steps_per_call=k, log_every=k)
    _start(tmp_path, "port.ckpt", init)
    _start(tmp_path, "jax.ckpt", init)
    pcfg = Config(**_follow_kw(tmp_path, fms, "port.ckpt", max_batches, **kw)).validate()
    jcfg = JaxConfig(telemetry_profile_costs=False,
                     **_follow_kw(tmp_path, fms, "jax.ckpt", max_batches, **kw)).validate()
    got = train(pcfg, resume=True, device="cpu", log=quiet)
    jax_train(jcfg, resume=True, log=quiet)
    assert got.step == batches
    cur, jcur = read_input_cursor(pcfg.model_file), jax_read_input_cursor(jcfg.model_file)
    assert cur == jcur
    assert cur["follow"] is True and cur["batch_in_epoch"] == batches
    assert stream.stream_prefix_matches([fms], cur["files"])
    losses = [r["loss"] for r in _train_records(pcfg.metrics_path)]
    jlosses = [r["loss"] for r in _train_records(jcfg.metrics_path)]
    assert len(losses) == len(jlosses) > 0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    mine = restore_checkpoint(pcfg.model_file, CPU, accum_width=1 + K)
    with np.load(jcfg.model_file) as z:
        np.testing.assert_allclose(mine.table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(mine.table_accum.numpy(), z["table_accum"], atol=1e-5)
    inputs = [r for r in map(json.loads, open(pcfg.metrics_path)) if r.get("kind") == "input"]
    assert sum(r["input_steps"] for r in inputs) == batches


def _same_arrays(a: str, b: str):
    with np.load(a) as za, np.load(b) as zb:
        for key in ("table", "table_accum", "step"):
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


@pytest.mark.parametrize("k", [1, 2])
def test_follow_resume_mid_stream_over_a_grown_file_is_bitwise(tmp_path, k):
    data = _data(21, 6)
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    whole = _write(stream, str(tmp_path / "whole.fms"), data)
    _start(tmp_path, "a.ckpt", init)
    train(Config(**_follow_kw(tmp_path, whole, "a.ckpt", 6, steps_per_call=k)).validate(),
          resume=True, device="cpu", log=quiet)
    grown = _write(stream, str(tmp_path / "grown.fms"), data[:4])
    _start(tmp_path, "b.ckpt", init)
    first = Config(**_follow_kw(tmp_path, grown, "b.ckpt", 4, steps_per_call=k)).validate()
    train(first, resume=True, device="cpu", log=quiet)
    assert read_input_cursor(first.model_file)["batch_in_epoch"] == 4
    _write(stream, grown, data[4:])  # rows land after the first run saved
    logs = []
    train(Config(**_follow_kw(tmp_path, grown, "b.ckpt", 6, steps_per_call=k)).validate(),
          resume=True, device="cpu", log=logs.append)
    assert "resuming input at epoch 0, batch 4 (exact-position cursor)" in logs
    _same_arrays(str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt"))


def test_follow_resume_over_a_changed_prefix_fails_loudly(tmp_path):
    p = _write(stream, str(tmp_path / "s.fms"), _data(22, 3))
    cfg = Config(**_follow_kw(tmp_path, p, "m.ckpt", 3)).validate()
    train(cfg, device="cpu", log=quiet)
    os.remove(p)
    _write(stream, p, _data(23, 3))
    with pytest.raises(ValueError, match="PREFIX changed"):
        train(cfg, resume=True, device="cpu", log=quiet)


def test_a_batch_cursor_under_a_follow_config_starts_the_stream_with_a_warning(tmp_path):
    """A cursor saved by a batch run (no ``follow``) never names a stream
    offset: the follow run starts at batch 0 and warns, as in JAX."""
    from fast_tffm_tpu.training import _resolve_cursor as jax_resolve_cursor
    from fast_tffm_tpu_torch.training import _resolve_cursor

    p = _write(stream, str(tmp_path / "s.fms"), _data(24, 1))
    kw = dict(batch_size=B, online_follow=True, train_files=(p,))
    cur = {"version": 1, "epoch": 0, "batch_in_epoch": 3, "batch_size": B, "shuffle": False,
           "shuffle_seed": 0, "files": "0123456789abcdef"}
    logs, jlogs = [], []
    assert _resolve_cursor(Config(**kw).validate(), dict(cur), logs.append) == (0, 0)
    assert jax_resolve_cursor(JaxConfig(**kw).validate(), dict(cur), jlogs.append) == (0, 0)
    assert [m.split(" — ")[0] for m in logs] == [m.split(" — ")[0] for m in jlogs]
    assert "warning" in logs[0]


@pytest.mark.parametrize("path", ["t.libsvm", "two"])
def test_follow_refuses_what_is_not_one_fms_stream(tmp_path, path):
    txt = tmp_path / "t.libsvm"
    txt.write_text("1 3:1.0 5:1.0\n0 2:1.0 4:1.0\n")
    files = (str(txt),) if path == "t.libsvm" else (str(txt), str(txt))
    kw = _follow_kw(tmp_path, str(txt), "m.ckpt", 1, metrics_path="")
    kw["train_files"] = files
    match = "FMS stream" if path == "t.libsvm" else "exactly ONE train file"
    with pytest.raises(ValueError, match=match):
        train(Config(**kw).validate(), device="cpu", log=quiet)
    with pytest.raises(ValueError, match=match):
        jax_train(JaxConfig(telemetry_profile_costs=False, **kw).validate(), log=quiet)


def _cli_cfg(tmp_path, fms) -> str:
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"[General]\nmodel = fm\norder = 3\nfactor_num = {K}\nvocabulary_size = {V}\n"
        f"model_file = {tmp_path / 'm.ckpt'}\n"
        f"[Train]\ntrain_files = {fms}\nmax_nnz = {W}\nbatch_size = {B}\nepoch_num = 1\n"
        "log_every = 1\nlearning_rate = 0.05\n"
        "[Online]\nfollow = true\npoll_s = 0.05\n"
    )
    return str(cfg)


def test_sigterm_while_the_stream_idles_saves_exits_0_and_resumes_bitwise(tmp_path):
    """An unbounded follow trainer (no idle timeout) on a quiet stream takes
    SIGTERM: it saves the cursor and exits 0; once more rows land, its
    resume ends bitwise the run over the whole stream."""
    data = _data(25, 4)
    fms = _write(stream, str(tmp_path / "s.fms"), data[:2])
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train", _cli_cfg(tmp_path, fms),
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    out = []
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:
            out.append(line)
            if line.startswith("step 2 ") or time.monotonic() > deadline:
                break
        time.sleep(0.5)  # both batches trained; the reader polls an idle file
        proc.send_signal(signal.SIGTERM)
        out.append(proc.stdout.read())
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(out)
    assert rc == 0, text[-2000:]
    assert "stopped on signal at step 2" in text
    cur = read_input_cursor(str(tmp_path / "m.ckpt"))
    assert cur["batch_in_epoch"] == 2 and cur["follow"] is True
    _write(stream, fms, data[2:])
    loaded = load_config(_cli_cfg(tmp_path, fms))
    cfg = dataclasses.replace(loaded, online_max_batches=4, online_idle_timeout_s=0.3)
    train(cfg, resume=True, device="cpu", log=quiet)
    whole = _write(stream, str(tmp_path / "whole.fms"), data)
    ref = dataclasses.replace(cfg, train_files=(whole,), model_file=str(tmp_path / "ref.ckpt"))
    train(ref, device="cpu", log=quiet)
    _same_arrays(ref.model_file, cfg.model_file)


# --- accum_restart_steps --------------------------------------------------------


@pytest.mark.parametrize("layout", ["rows", "packed-element", "packed-row"])
def test_accum_restart_fills_every_accumulator_in_place(layout):
    cfg = Config(model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=W).validate()
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    if layout == "rows":
        state = init_state(model, g, 0.1)
        step = make_train_step(model, 0.1)
    else:
        from fast_tffm_tpu_torch.trainer import make_packed_train_step

        state = init_packed_state(model, g, 0.1, layout.split("-")[1])
        step = make_packed_train_step(model, 0.1)
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.data.libsvm import ParsedBatch

    l, i, v, z = _rows(np.random.default_rng(30), B)
    parsed = ParsedBatch(l.astype(np.float32), i.astype(np.int32), v.astype(np.float32),
                         np.zeros((B, W), np.int32), z.astype(np.int32))
    for _ in range(2):
        state, _ = step(state, Batch.from_parsed(parsed))
    before, accum, steps = state.table.clone(), state.table_accum, state.step
    assert (accum != np.float32(0.1)).any()
    out = make_accum_restart(0.1)(state)
    assert out.table_accum is accum  # the same tensor, filled
    assert (accum == np.float32(0.1)).all()
    assert torch.equal(out.table, before) and out.step == steps
    if layout != "rows":  # the packed init state, bit for bit
        fresh = init_packed_state(model, torch.Generator().manual_seed(0), 0.1,
                                  layout.split("-")[1])
        assert torch.equal(accum, fresh.table_accum)


def test_accum_restart_train_matches_jax_and_k1_equals_k4(tmp_path):
    """Resets at steps 4, 8 and 12 of a 14-step follow run (from a shared
    npz): the port's K = 1 run within the training tolerance of the JAX
    run, and bitwise the port's K = 4 run (the K-aligned grid is the same
    at a multiple of K).  The accumulators end below a run's without
    restarts."""
    fms = _write(stream, str(tmp_path / "s.fms"), _data(31, 16))
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    runs = {}
    for name, k, restart in (("k1", 1, 4), ("k4", 4, 4), ("none", 1, 0)):
        _start(tmp_path, f"{name}.ckpt", init)
        cfg = Config(**_follow_kw(tmp_path, fms, f"{name}.ckpt", 16, steps_per_call=k,
                                  online_accum_restart_steps=restart)).validate()
        runs[name] = unpack_state(train(cfg, resume=True, device="cpu", log=quiet),
                                  build_model(cfg))
    _start(tmp_path, "jax.ckpt", init)
    jax_train(JaxConfig(telemetry_profile_costs=False,
                        **_follow_kw(tmp_path, fms, "jax.ckpt", 16,
                                     online_accum_restart_steps=4)).validate(),
              resume=True, log=quiet)
    assert torch.equal(runs["k1"].table, runs["k4"].table)
    assert torch.equal(runs["k1"].table_accum, runs["k4"].table_accum)
    with np.load(tmp_path / "jax.ckpt") as z:
        np.testing.assert_allclose(runs["k1"].table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(runs["k1"].table_accum.numpy(), z["table_accum"], atol=1e-5)
    assert float(runs["k1"].table_accum.sum()) < float(runs["none"].table_accum.sum())


def test_accum_restart_resets_on_the_absolute_grid_after_a_resume(tmp_path):
    """A run stopped at step 6 and resumed resets at step 8 as the run
    that never stopped does (the grid is absolute multiples of N)."""
    data = _data(32, 12)
    init = tmp_path / "init.ckpt"
    _shared_npz(init)
    whole = _write(stream, str(tmp_path / "whole.fms"), data)
    _start(tmp_path, "a.ckpt", init)
    kw = dict(online_accum_restart_steps=4, metrics_path="")
    train(Config(**_follow_kw(tmp_path, whole, "a.ckpt", 12, **kw)).validate(), resume=True,
          device="cpu", log=quiet)
    grown = _write(stream, str(tmp_path / "grown.fms"), data[:6])
    _start(tmp_path, "b.ckpt", init)
    for n in (6, 12):
        if n == 12:
            _write(stream, grown, data[6:])
        train(Config(**_follow_kw(tmp_path, grown, "b.ckpt", n, **kw)).validate(),
              resume=True, device="cpu", log=quiet)
    _same_arrays(str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt"))


# --- the config -----------------------------------------------------------------


@pytest.mark.parametrize(
    "kw,needle",
    [
        (dict(online_follow=True, shuffle=True), "shuffle"),
        (dict(online_follow=True, epoch_num=2), "epoch_num"),
        (dict(online_follow=True, device_cache=True), "device_cache"),
        (dict(online_follow=True, dedup_gather_rows=64), "per-batch cap"),
        (dict(online_adagrad_decay=0.9, table_layout="packed"), "rows"),
        (dict(online_adagrad_decay=0.9, online_accum_restart_steps=5), "exclusive"),
        (dict(online_accum_restart_steps=5, delta_every_steps=10), "delta"),
        (dict(online_accum_restart_steps=5, adagrad_accumulator="fused",
              table_layout="packed"), "fused"),
        (dict(online_adagrad_decay=0.0), "adagrad_decay"),
        (dict(online_poll_s=0.0), "poll_s"),
        (dict(online_idle_timeout_s=-1.0), "idle_timeout_s"),
        (dict(online_max_batches=-1), "max_batches"),
        (dict(online_accum_restart_steps=-1), "accum_restart_steps"),
        (dict(max_rollbacks=-1), "max_rollbacks"),
    ],
    ids=lambda x: ",".join(x) if isinstance(x, dict) else x,
)
def test_config_rejects_the_online_combinations_jax_rejects(kw, needle):
    with pytest.raises(ValueError, match=needle) as mine:
        Config(**kw).validate()
    with pytest.raises(ValueError, match=needle) as theirs:
        JaxConfig(**kw).validate()
    assert str(mine.value) == str(theirs.value)


def test_online_and_resilience_keys_load_like_jax(tmp_path):
    from fast_tffm_tpu.config import load_config as jax_load_config
    from fast_tffm_tpu_torch.config import load_config

    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        "[General]\nvocabulary_size = 64\n[Train]\nepoch_num = 1\n"
        "[Online]\nfollow = true\npoll_s = 0.5\nidle_timeout_s = 3\nmax_batches = 9\n"
        "accum_restart_steps = 4\n[Resilience]\non_nan = rollback\nmax_rollbacks = 5\n"
    )
    got, want = load_config(str(cfg)), jax_load_config(str(cfg))
    for f in ("online_follow", "online_poll_s", "online_idle_timeout_s", "online_max_batches",
              "online_accum_restart_steps", "on_nan", "max_rollbacks"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.online_poll_s, got.online_max_batches, got.max_rollbacks) == (0.5, 9, 5)
