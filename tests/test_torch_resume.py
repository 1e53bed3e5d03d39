"""Port: the exact-position resume, against the JAX package, on the CPU.

* The ``input_cursor`` member: written by ``save_checkpoint(cursor=)``,
  read back by ``read_input_cursor``; each package reads the other's file
  and the member's bytes are the same.
* ``_files_fingerprint`` and ``_resolve_cursor`` give the JAX functions'
  answers on the cases of tests/test_resilience.py, and on cursor vectors.
* The seek: ``batch_stream(skip_rows=)`` on the Python text, native, FMB
  and shuffled FMB routes gives exactly the suffix of the full stream, and
  the JAX ``batch_stream``'s batches; ``epoch_index_chunks(start=)``
  equals the JAX function's over a grid.
* Stop and resume: a run stopped by SIGTERM from its ``step_hook`` saves
  the cursor and returns; ``--resume`` ends bitwise (``torch.equal``)
  equal to the run that was never stopped, on streamed text, FMB with
  shuffle (K = 1 and 8), the device cache (K = 1, 2 and 8, and a K = 1
  save resumed at K = 8), the rows, fused and packed layouts.  A
  pre-cursor checkpoint resumes with the legacy note.
* Across packages: each package resumes the other's mid-epoch checkpoint
  at the same batch and ends within the tolerance the two trainers are
  held to (atol 1e-5 on the final arrays and on the printed losses, as in
  tests/test_torch_training.py) of the other package's own resume.
* ``cli convert`` packs every configured file and counts failures per file
  (tests/test_e2e.py's cases).
"""

import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import _cursor_entry as jax_cursor_entry
from fast_tffm_tpu.checkpoint import read_input_cursor as jax_read_input_cursor
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.data import device_cache as jax_device_cache
from fast_tffm_tpu.data import pipeline as jax_pipeline
from fast_tffm_tpu.data.native import load_native_parser as jax_load_native_parser
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import _files_fingerprint as jax_files_fingerprint
from fast_tffm_tpu.training import _resolve_cursor as jax_resolve_cursor
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch import cli
from fast_tffm_tpu_torch.checkpoint import read_input_cursor, restore_checkpoint, save_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data import binary
from fast_tffm_tpu_torch.data.device_cache import epoch_index_chunks
from fast_tffm_tpu_torch.data.native import best_parser
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.trainer import TrainState, unpack_state
from fast_tffm_tpu_torch.training import _files_fingerprint, _resolve_cursor, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20
CPU = torch.device("cpu")


def quiet(*_):
    pass


def _jax_cfg(**kw):
    return JaxConfig(telemetry_profile_costs=False, **kw).validate()


def _kw(tmp_path, name, **kw):
    """Both packages' settings (baseline5's model at a small vocabulary, 2
    epochs of 20 batches); the data files are copied into ``tmp_path``,
    where ``binary_cache`` writes their caches."""
    for src in (TRAIN, TEST):
        if not (tmp_path / os.path.basename(src)).exists():
            shutil.copy(src, tmp_path)
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        validation_files=(str(tmp_path / "test.libsvm"),), epoch_num=2, batch_size=B,
        learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=3, thread_num=2,
    )
    base.update(kw)
    return base


def _shared_npz(path, accumulator="element", seed=0):
    """A seeded [V, 1+K] table with accumulators at 0.1, saved by the JAX
    package without a cursor (every run below resumes from a copy)."""
    jcfg = _jax_cfg(model="fm", order=3, factor_num=K, vocabulary_size=V,
                    adagrad_accumulator="row" if accumulator == "fused" else accumulator)
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1,
                           "row" if accumulator in ("row", "fused") else "element")
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _sigterm_at(at_step, fired):
    """A step hook that raises SIGTERM once, at the first call that
    reaches ``at_step``."""

    def hook(step):
        if step >= at_step and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)

    return hook


def _logical(state, cfg):
    return unpack_state(state, build_model(cfg))


def _assert_same(a: TrainState, b: TrainState):
    assert a.step == b.step
    assert torch.equal(a.table, b.table)
    assert torch.equal(a.table_accum, b.table_accum)


# --- the cursor member ------------------------------------------------------


def _cursor(**kw):
    return dict({"version": 1, "epoch": 1, "batch_in_epoch": 7, "batch_size": B,
                 "shuffle": True, "shuffle_seed": 5, "steps_per_call": 1,
                 "files": "0123456789abcdef"}, **kw)


def _small_state():
    rng = np.random.default_rng(3)
    return TrainState(
        table=torch.from_numpy(rng.uniform(-1, 1, (16, 5)).astype(np.float32)), dense=[],
        step=4, table_accum=torch.full((16, 5), 0.1),
    )


def test_cursor_round_trips_and_each_package_reads_the_others(tmp_path):
    cur = _cursor()
    port_path, jax_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    save_checkpoint(port_path, _small_state(), cursor=cur)
    assert read_input_cursor(port_path) == cur
    assert jax_read_input_cursor(port_path) == cur
    jcfg = _jax_cfg(model="fm", order=3, factor_num=4, vocabulary_size=16)
    jax_save_checkpoint(jax_path, jax_init_state(jax_build_model(jcfg), jax.random.key(0)),
                        cursor=cur)
    assert read_input_cursor(jax_path) == cur
    with np.load(port_path) as z, np.load(jax_path) as zj:
        assert z["input_cursor"].dtype == np.uint8
        assert z["input_cursor"].tobytes() == zj["input_cursor"].tobytes()
        assert z["input_cursor"].tobytes() == jax_cursor_entry(cur).tobytes()
        assert json.loads(z["input_cursor"].tobytes()) == cur


def test_cursorless_or_missing_checkpoint_reads_none(tmp_path):
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, _small_state())
    assert read_input_cursor(path) is None and jax_read_input_cursor(path) is None
    assert read_input_cursor(str(tmp_path / "absent.ckpt")) is None
    with open(path, "wb") as f:  # a member that is not a JSON object
        np.savez(f, table=np.zeros((2, 2), np.float32),
                 input_cursor=np.frombuffer(b"[1, 2]", np.uint8))
    assert read_input_cursor(path) is None and jax_read_input_cursor(path) is None


# --- fingerprint and resolution ---------------------------------------------


def _resolve_both(tmp_path, cursor, **kw):
    """Both packages' (start_epoch, start_batch) and warnings for one cursor."""
    data = tmp_path / "x.libsvm"
    if not data.exists():
        shutil.copy(TRAIN, data)
    base = dict(model="fm", order=3, factor_num=K, vocabulary_size=V, batch_size=32,
                epoch_num=2, train_files=(str(data),))
    base.update(kw)
    logs, jlogs = [], []
    copy = lambda: None if cursor is None else dict(cursor)  # noqa: E731 (both mutate it)
    got = _resolve_cursor(Config(**base).validate(), copy(), logs.append)
    want = jax_resolve_cursor(_jax_cfg(**base), copy(), jlogs.append)
    assert got == want
    assert [l.split(" — ")[0] for l in logs] == [l.split(" — ")[0] for l in jlogs]
    return got, logs


def test_files_fingerprint_matches_jax(tmp_path):
    a, b = tmp_path / "a.libsvm", tmp_path / "b.libsvm"
    shutil.copy(TRAIN, a)
    shutil.copy(TEST, b)
    for files in ([str(a)], [str(a), str(b)], [str(b), str(a)], [str(tmp_path / "none")]):
        assert _files_fingerprint(files) == jax_files_fingerprint(files)
    before = _files_fingerprint([str(a)])
    with open(a, "a") as f:
        f.write("1 0:1.0\n")
    assert _files_fingerprint([str(a)]) != before
    assert _files_fingerprint([str(a)]) == jax_files_fingerprint([str(a)])


@pytest.mark.parametrize(
    "change,want",
    [
        ({}, (1, 3)),
        (dict(batch_size=64), (0, 0)),  # the position means something else now
        (dict(shuffle=True), (0, 0)),
        (dict(epoch=2), (0, 0)),  # a completed run: epoch_num more epochs
        (dict(epoch=2, _exact=True), (2, 0)),  # an exact cursor is literal
        (dict(epoch=5, batch_in_epoch=9, _exact=True), (2, 0)),
        (dict(version=9), (0, 0)),
        (dict(follow=True), (0, 0)),  # a follow cursor never matches a batch run
        (dict(files="ffffffffffffffff"), (0, 0)),
        (dict(hosts=[{"epoch": 1, "batch_in_epoch": 4}]), (1, 4)),  # one process's vector
        (dict(hosts=[{"epoch": 1, "batch_in_epoch": 4}] * 2), (0, 0)),  # another topology
        (dict(hosts=[{"epoch": 1, "batch_in_epoch": 4}], process_count=2), (0, 0)),
        (dict(hosts=[None]), (1, 3)),
    ],
    ids=lambda x: json.dumps(x) if isinstance(x, dict) else str(x),
)
def test_resolve_cursor_matches_jax(tmp_path, change, want):
    data = tmp_path / "x.libsvm"
    shutil.copy(TRAIN, data)
    cur = {"version": 1, "epoch": 1, "batch_in_epoch": 3, "batch_size": 32,
           "shuffle": False, "shuffle_seed": 0, "files": _files_fingerprint([str(data)])}
    got, logs = _resolve_both(tmp_path, dict(cur, **change))
    assert got == want
    if want == (0, 0):
        assert any("warning" in l for l in logs) or change.get("epoch", 0) >= 2
    elif not change.get("_exact"):
        assert logs == [f"resuming input at epoch {want[0]}, batch {want[1]} "
                        "(exact-position cursor)"]


def test_resolve_cursor_after_the_files_change(tmp_path):
    """The online-append case: a cursor saved over other files starts the
    data again, in both packages (tests/test_resilience.py's case)."""
    data = tmp_path / "x.libsvm"
    shutil.copy(TRAIN, data)
    cur = {"version": 1, "epoch": 1, "batch_in_epoch": 3, "batch_size": 32,
           "shuffle": False, "shuffle_seed": 0, "files": _files_fingerprint([str(data)])}
    assert _resolve_both(tmp_path, cur)[0] == (1, 3)
    with open(data, "a") as f:
        f.write("1 0:1.0 1:1.0 2:1.0 3:1.0\n")
    got, logs = _resolve_both(tmp_path, cur)
    assert got == (0, 0) and any("files" in l and "does not match" in l for l in logs)
    assert _resolve_both(tmp_path, None)[0] == (0, 0)


# --- the seek -----------------------------------------------------------------


def _equal_batches(got, want):
    assert len(got) == len(want)
    for (p, w), (q, x) in zip(got, want):
        for f in ("labels", "ids", "vals", "fields", "nnz"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f), err_msg=f)
        np.testing.assert_array_equal(w, x)


@pytest.fixture(scope="module")
def fmb_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fmb")
    src = str(tmp / "train.libsvm")
    shutil.copy(TRAIN, src)
    return binary.write_fmb(src, src + ".fmb", vocabulary_size=V)


@pytest.mark.parametrize("route", ["python", "native", "fmb", "fmb_shuffled"])
@pytest.mark.parametrize("skip", [0, 1, 3, 19, 20, 21])
def test_skip_rows_gives_the_suffix_and_the_jax_batches(fmb_file, route, skip):
    kw = dict(batch_size=B, vocabulary_size=V, max_nnz=NNZ)
    files, jkw = [TRAIN], {}
    if route == "native":
        kw["parser"], jkw["parser"] = best_parser(2), jax_load_native_parser(2)
    elif route.startswith("fmb"):
        files = [fmb_file]
        if route == "fmb_shuffled":
            kw["shuffle_seed"] = 11
    full = list(batch_stream(files, **kw))
    assert len(full) == 20
    part = list(batch_stream(files, skip_rows=skip * B, **kw))
    _equal_batches(part, full[skip:])
    _equal_batches(part, list(jax_pipeline.batch_stream(files, skip_rows=skip * B,
                                                        **dict(kw, **jkw))))
    # Skipped batches count toward pad_to_batches: exactly the remaining ones.
    padded = list(batch_stream(files, skip_rows=skip * B, pad_to_batches=23, **kw))
    assert len(padded) == 23 - min(skip, 23)
    _equal_batches(padded, list(jax_pipeline.batch_stream(
        files, skip_rows=skip * B, pad_to_batches=23, **dict(kw, **jkw))))


def test_shuffled_seek_redraws_the_epochs_permutation(fmb_file):
    """A seek into a later epoch of a multi-epoch shuffled stream takes
    that epoch's order, not epoch 0's."""
    kw = dict(batch_size=B, vocabulary_size=V, max_nnz=NNZ, shuffle_seed=3, epochs=2)
    full = list(batch_stream([fmb_file], **kw))
    assert len(full) == 40
    _equal_batches(list(batch_stream([fmb_file], skip_rows=27 * B, **kw)), full[27:])
    assert not np.array_equal(full[27][0].ids, full[7][0].ids)


@pytest.mark.parametrize("batches", [1, 7, 20, 24])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_epoch_index_chunks_start_matches_jax(batches, k):
    for start in range(batches + 2):
        got = epoch_index_chunks(batches, k, start=start)
        want = jax_device_cache.epoch_index_chunks(batches, k, start=start)
        assert [c.tolist() for c in got] == [np.asarray(c).tolist() for c in want]
        assert sum(c.numel() for c in got) == max(0, batches - start)
        # The K-grid of an uninterrupted epoch: only the first chunk is clipped.
        assert all(int(c[0]) % k == 0 for c in got[1:])


# --- stop and resume ----------------------------------------------------------

# (input, K, layout): streamed text (native parser), FMB with shuffle, the
# device cache; rows, fused and packed.
RESUME_CASES = [
    (dict(), 1, "rows", 27),
    (dict(binary_cache=True, shuffle=True, shuffle_seed=5), 1, "rows", 27),
    (dict(binary_cache=True, shuffle=True, shuffle_seed=5), 1, "fused", 27),
    (dict(binary_cache=True, shuffle=True, shuffle_seed=5), 1, "element", 27),
    (dict(binary_cache=True, shuffle=True, shuffle_seed=5), 1, "row", 27),
    (dict(binary_cache=True, shuffle=True, shuffle_seed=5), 8, "rows", 23),
    (dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5), 1, "rows", 27),
    (dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5), 2, "rows", 27),
    (dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5), 2, "fused", 27),
    (dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5), 8, "rows", 23),
    (dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5), 8, "fused", 23),
    (dict(device_cache=True, binary_cache=True), 8, "rows", 5),
]
LAYOUT_KW = {
    "rows": dict(adagrad_accumulator="element"),
    "fused": dict(table_layout="packed", adagrad_accumulator="fused"),
    "element": dict(table_layout="packed", adagrad_accumulator="element"),
    "row": dict(table_layout="packed", adagrad_accumulator="row"),
}


def _case_id(case):
    mode, k, layout, at = case
    src = "cached" if mode.get("device_cache") else "fmb" if mode.get("binary_cache") else "text"
    return f"{src}{'-shuffle' if mode.get('shuffle') else ''}-K{k}-{layout}-stop{at}"


def _port_cfg(tmp_path, name, mode, k, layout, **kw):
    return Config(**_kw(tmp_path, name, steps_per_call=k, **mode, **LAYOUT_KW[layout],
                        **kw)).validate()


@pytest.mark.parametrize("case", RESUME_CASES, ids=_case_id)
def test_stopped_and_resumed_run_is_bitwise_the_uninterrupted_run(tmp_path, case):
    mode, k, layout, at = case
    _shared_npz(tmp_path / "init.ckpt", LAYOUT_KW[layout]["adagrad_accumulator"])
    whole = _port_cfg(tmp_path, "whole.ckpt", mode, k, layout)
    cut = _port_cfg(tmp_path, "cut.ckpt", mode, k, layout)
    for cfg in (whole, cut):
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    want = train(whole, resume=True, log=quiet, device="cpu")
    assert want.step == 40
    before = signal.getsignal(signal.SIGTERM)
    fired, log = [], []
    stopped = train(cut, resume=True, log=log.append, device="cpu",
                    step_hook=_sigterm_at(at, fired))
    assert signal.getsignal(signal.SIGTERM) is before  # handlers restored
    stop_step = fired[0]
    assert stopped.step == stop_step < 40 and stop_step % k in (0, 20 % k)
    assert f"stopped on signal at step {stop_step}, model -> {cut.model_file} " \
           "(resume with --resume)" in log
    epoch, batch = divmod(stop_step, 20)
    assert read_input_cursor(cut.model_file) == {
        "version": 1, "epoch": epoch, "batch_in_epoch": batch, "batch_size": B,
        "shuffle": bool(mode.get("shuffle")), "shuffle_seed": mode.get("shuffle_seed", 0),
        "steps_per_call": k, "files": _files_fingerprint(cut.train_files),
    }
    log.clear()
    resumed = train(cut, resume=True, log=log.append, device="cpu")
    assert f"resuming input at epoch {epoch}, batch {batch} (exact-position cursor)" in log
    assert not any("legacy" in l for l in log)
    _assert_same(_logical(resumed, cut), _logical(want, whole))
    # The saves agree too, and the final one names the end of the run.
    width = 1 + K if LAYOUT_KW[layout]["adagrad_accumulator"] == "element" else 1
    _assert_same(restore_checkpoint(cut.model_file, CPU, accum_width=width),
                 restore_checkpoint(whole.model_file, CPU, accum_width=width))
    assert read_input_cursor(cut.model_file)["epoch"] == 2
    assert read_input_cursor(cut.model_file)["batch_in_epoch"] == 0


def test_a_k1_save_resumed_at_k8_is_still_bitwise(tmp_path):
    """A cursor lands mid-chunk when a K = 1 run's save resumes at K = 8:
    the first chunk is clipped and the run stays bitwise."""
    mode = dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5)
    _shared_npz(tmp_path / "init.ckpt")
    whole = _port_cfg(tmp_path, "whole.ckpt", mode, 1, "rows")
    cut = _port_cfg(tmp_path, "cut.ckpt", mode, 1, "rows")
    for cfg in (whole, cut):
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    want = train(whole, resume=True, log=quiet, device="cpu")
    fired = []
    train(cut, resume=True, log=quiet, device="cpu", step_hook=_sigterm_at(13, fired))
    assert read_input_cursor(cut.model_file)["batch_in_epoch"] == 13
    got = train(dataclasses.replace(cut, steps_per_call=8), resume=True, log=quiet, device="cpu")
    _assert_same(got, want)


def test_stop_at_an_epochs_last_batch_resumes_at_its_end(tmp_path):
    """Stopped on the epoch's last batch, the cursor names that epoch's
    end; the resumed run validates, saves and goes on with the next."""
    mode = dict(binary_cache=True)
    _shared_npz(tmp_path / "init.ckpt")
    whole = _port_cfg(tmp_path, "whole.ckpt", mode, 1, "rows")
    cut = _port_cfg(tmp_path, "cut.ckpt", mode, 1, "rows")
    for cfg in (whole, cut):
        shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    want = train(whole, resume=True, log=quiet, device="cpu")
    train(cut, resume=True, log=quiet, device="cpu", step_hook=_sigterm_at(20, []))
    assert read_input_cursor(cut.model_file)["epoch"] == 0
    assert read_input_cursor(cut.model_file)["batch_in_epoch"] == 20
    log = []
    _assert_same(train(cut, resume=True, log=log.append, device="cpu"), want)
    assert any(l.startswith("epoch 0 validation auc") for l in log)


def test_every_save_carries_the_cursor_of_the_next_epoch(tmp_path):
    _shared_npz(tmp_path / "init.ckpt")
    cfg = Config(**_kw(tmp_path, "m.ckpt", save_every_epochs=1)).validate()
    shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    seen = []

    def log(msg):
        if "checkpoint ->" in msg:
            seen.append(read_input_cursor(cfg.model_file))

    train(cfg, resume=True, log=log, device="cpu")
    assert [(c["epoch"], c["batch_in_epoch"]) for c in seen] == [(1, 0), (2, 0)]
    assert read_input_cursor(cfg.model_file)["epoch"] == 2


def test_a_pre_cursor_checkpoint_resumes_from_the_first_file(tmp_path):
    _shared_npz(tmp_path / "init.ckpt")
    cfg = Config(**_kw(tmp_path, "m.ckpt")).validate()
    shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    log = []
    first = train(cfg, resume=True, log=log.append, device="cpu")
    assert first.step == 40
    assert ("note: checkpoint carries no input cursor (pre-resilience format) — input "
            "restarts at the first file (legacy resume)") in log
    # A completed run's cursor: epoch_num more epochs on top.
    log.clear()
    assert train(cfg, resume=True, log=log.append, device="cpu").step == 80
    assert not any("legacy" in l or "resuming input" in l for l in log)


def test_a_mismatched_cursor_warns_and_starts_the_data_again(tmp_path):
    _shared_npz(tmp_path / "init.ckpt")
    cfg = Config(**_kw(tmp_path, "m.ckpt", binary_cache=True)).validate()
    shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    train(cfg, resume=True, log=quiet, device="cpu", step_hook=_sigterm_at(7, []))
    log = []
    state = train(dataclasses.replace(cfg, batch_size=40), resume=True, log=log.append,
                  device="cpu")
    assert any("does not match this config (batch_size 20 != 40)" in l for l in log)
    assert state.step == 7 + 20


# --- across packages ----------------------------------------------------------


def _losses(lines):
    return [float(s.split()[5]) for s in lines if s.startswith("step ")]


@pytest.mark.parametrize("stopper", ["jax", "port"])
def test_each_package_resumes_the_others_mid_epoch_checkpoint(tmp_path, stopper):
    """One package stops at step 27 (epoch 1, batch 7) of a shuffled FMB
    run; both resume that file.  The resumes start at the same batch and
    end within atol 1e-5 of each other (float32 summation order)."""
    mode = dict(binary_cache=True, shuffle=True, shuffle_seed=5)
    _shared_npz(tmp_path / "init.ckpt")
    stop_path = str(tmp_path / "stopped.ckpt")
    shutil.copy(tmp_path / "init.ckpt", stop_path)
    kw = _kw(tmp_path, "stopped.ckpt", **mode)
    fired = []
    if stopper == "jax":
        jax_train(_jax_cfg(**kw), resume=True, log=quiet, step_hook=_sigterm_at(27, fired))
    else:
        train(Config(**kw).validate(), resume=True, log=quiet, device="cpu",
              step_hook=_sigterm_at(27, fired))
    assert fired == [27]
    cursor = read_input_cursor(stop_path)
    assert jax_read_input_cursor(stop_path) == cursor
    assert (cursor["epoch"], cursor["batch_in_epoch"]) == (1, 7)
    jcfg = _jax_cfg(**dict(kw, model_file=str(tmp_path / "jax.ckpt")))
    cfg = Config(**dict(kw, model_file=str(tmp_path / "port.ckpt"))).validate()
    shutil.copy(stop_path, jcfg.model_file)
    shutil.copy(stop_path, cfg.model_file)
    jlog, log = [], []
    jax_train(jcfg, resume=True, log=jlog.append)
    state = train(cfg, resume=True, log=log.append, device="cpu")
    seek = "resuming input at epoch 1, batch 7 (exact-position cursor)"
    assert seek in log and seek in jlog
    assert state.step == 40
    got, want = _losses(log), _losses(jlog)
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, atol=1e-5)
    mine = restore_checkpoint(cfg.model_file, CPU, accum_width=1 + K)
    with np.load(jcfg.model_file) as z:
        assert int(z["step"]) == 40
        np.testing.assert_allclose(mine.table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(mine.table_accum.numpy(), z["table_accum"], atol=1e-5)
    assert read_input_cursor(cfg.model_file) == jax_read_input_cursor(jcfg.model_file)


# --- convert --------------------------------------------------------------------


def _convert_cfg(tmp_path, train_file=None, name="run.cfg"):
    """A config whose train, validation and predict files are copies of the
    repo's data in ``tmp_path`` (``train_file`` replaces the train list)."""
    for src in (TRAIN, TEST):
        shutil.copy(src, tmp_path)
    cfg = tmp_path / name
    cfg.write_text("\n".join([
        "[General]", "order = 3", "factor_num = 8", f"vocabulary_size = {V}",
        f"model_file = {tmp_path / 'm.ckpt'}",
        "[Train]", f"train_files = {train_file or tmp_path / 'train.libsvm'}",
        f"validation_files = {tmp_path / 'test.libsvm'}", f"batch_size = {B}",
        "[Predict]", f"predict_files = {tmp_path / 'test.libsvm'}",
        f"score_path = {tmp_path / 's.txt'}",
    ]) + "\n")
    return str(cfg)


def test_cli_convert_packs_configured_files(tmp_path, capsys):
    cfg = _convert_cfg(tmp_path)
    assert cli.main(["convert", cfg, "--device", "cpu"]) == 0
    out = capsys.readouterr()
    for name in ("train.libsvm", "test.libsvm"):
        assert binary.is_fmb(str(tmp_path / name) + ".fmb")
        assert f"{tmp_path / name} -> {tmp_path / name}.fmb" in out.out
    assert "binary_cache = false" in out.err
    stamp = os.stat(str(tmp_path / "train.libsvm.fmb")).st_mtime_ns
    assert cli.main(["convert", cfg, "--device", "cpu"]) == 0
    assert os.stat(str(tmp_path / "train.libsvm.fmb")).st_mtime_ns == stamp
    # train consumes the pre-built caches: fresh, so no rebuild.
    log = []
    from fast_tffm_tpu_torch.config import load_config

    train(dataclasses.replace(load_config(cfg), binary_cache=True).validate(), log=log.append,
          device="cpu")
    assert os.stat(str(tmp_path / "train.libsvm.fmb")).st_mtime_ns == stamp
    assert not any("building binary cache" in l for l in log)
    # An FMB file in the lists passes through.
    fmb = str(tmp_path / "train.libsvm.fmb")
    capsys.readouterr()
    assert cli.main(["convert", _convert_cfg(tmp_path, fmb, "fmb.cfg"), "--device", "cpu"]) == 0
    assert f"{fmb} (already FMB)" in capsys.readouterr().out


def test_cli_convert_reports_per_file_failures(tmp_path, monkeypatch, capsys):
    cfg = _convert_cfg(tmp_path)
    real = binary.write_fmb

    def picky(src, dst, **kw):
        if "test" in os.path.basename(src):
            raise OSError("read-only file system")
        return real(src, dst, **kw)

    monkeypatch.setattr(binary, "write_fmb", picky)
    monkeypatch.setattr(binary, "_BUILD_FAILED", set())
    assert cli.main(["convert", cfg, "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "FAILED" in err and "1 of 2 files not converted" in err
    assert binary.is_fmb(str(tmp_path / "train.libsvm.fmb"))  # the other still packed
    assert not os.path.exists(str(tmp_path / "test.libsvm.fmb"))
    # A malformed file fails alone too.
    monkeypatch.setattr(binary, "_BUILD_FAILED", set())
    monkeypatch.setattr(binary, "write_fmb", real)
    (tmp_path / "test.libsvm").write_text("1 5:x\n")
    assert cli.main(["convert", cfg, "--device", "cpu"]) == 1
    assert "1 of 2 files not converted" in capsys.readouterr().err


def test_cli_convert_keeps_the_device_rule(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    cfg = _convert_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["convert", cfg])
    assert not os.path.exists(str(tmp_path / "train.libsvm.fmb"))
