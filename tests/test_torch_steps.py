"""Port: the K-step and device-cached train steps, and ``training.train``
on its input paths, on the CPU.

* ``make_scanned_train_step``: K steps per call, bitwise (``torch.equal``)
  K single steps, with the short tail group, on the rows and fused
  layouts;
* ``ops.tail.rows_restored``, the K-step graph's warm-up guard: K steps
  run inside it on every table layout leave the table and accumulator
  bitwise as they were (the same steps outside it move them);
* ``make_cached_train_step`` / ``make_cached_scan_train_step``: the
  resident-epoch steps bitwise the streamed steps on the same batches,
  shuffled and unshuffled, on both layouts;
* ``training.train`` against the JAX ``train`` from one npz with
  ``binary_cache`` + ``shuffle`` and with ``device_cache`` +
  ``steps_per_call = 3`` (shuffled, 2 epochs): the final table and
  accumulators within atol 1e-5 and the printed (5-decimal) losses within
  1e-5, as in tests/test_torch_training.py (float32, summation order);
  validation AUC within 1e-4;
* ``prediction.predict`` over an FMB file and with ``binary_cache``: the
  JAX ``predict``'s score file within 1e-6.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data import binary, device_cache
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import (
    make_packed_train_step,
    make_scanned_train_step,
    make_train_step,
    pack_state,
    packed_train_step_body,
    train_step_body,
)
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20
CPU = torch.device("cpu")
LAYOUTS = ["rows", "fused"]


def _state(layout, seed=0):
    """A seeded table ([V, 1+K]) with a row (fused) or element (rows)
    accumulator, in ``layout``."""
    rng = np.random.default_rng(seed)
    model = build_model(Config(order=3, factor_num=K, vocabulary_size=V,
                               factor_lambda=1e-4, bias_lambda=1e-4))
    from fast_tffm_tpu_torch.trainer import TrainState

    table = torch.from_numpy(rng.uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32))
    width = 1 if layout == "fused" else 1 + K
    accum = torch.from_numpy(rng.uniform(0.1, 0.4, size=(V, width)).astype(np.float32))
    state = TrainState(table=table, dense=[], step=0, table_accum=accum)
    return model, (pack_state(state, 0.1, fused=True) if layout == "fused" else state)


def _body(layout):
    return packed_train_step_body if layout == "fused" else train_step_body


def _clone(state):
    return dataclasses.replace(
        state, table=state.table.clone(),
        table_accum=None if state.table_accum is None else state.table_accum.clone(),
    )


def _same(a, b):
    assert a.step == b.step and a.layout == b.layout
    assert torch.equal(a.table, b.table)
    assert (a.table_accum is None) == (b.table_accum is None)
    if a.table_accum is not None:
        assert torch.equal(a.table_accum, b.table_accum)


def _pairs(n=11, **kw):
    return list(batch_stream([TRAIN], batch_size=B, vocabulary_size=V, max_nnz=NNZ, **kw))[:n]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", [1, 3, 4])
def test_scanned_step_is_bitwise_k_single_steps(layout, k):
    model, state = _state(layout)
    pairs = _pairs(11)  # 11 = 3 groups of 3 + a tail of 2; 2 of 4 + a tail of 3
    single = (make_packed_train_step if layout == "fused" else make_train_step)(model, 0.05)
    seq, want = _clone(state), []
    for parsed, w in pairs:
        seq, loss = single(seq, Batch.from_parsed(parsed, w))
        want.append(loss)
    scanned = make_scanned_train_step(model, 0.05, body=_body(layout))
    got = []
    for lo in range(0, len(pairs), k):
        group = pairs[lo : lo + k]
        state, losses = scanned(state, Batch.stack_parsed([p for p, _ in group],
                                                          [w for _, w in group]))
        assert losses.shape == (len(group),)
        got.extend(losses)
    assert torch.equal(torch.stack(got), torch.stack(want))
    _same(state, seq)
    assert state.step == 11 and scanned.graphs.replays == 0  # no graph on the CPU


@pytest.mark.parametrize("layout", ["rows", "rows_row", "packed", "packed_row", "fused"])
def test_k_steps_inside_rows_restored_leave_the_state_as_it_was(layout):
    """The warm-up that ``StepGraphs`` runs before a capture: K steps on the
    live table and accumulator inside ``rows_restored`` put back every row
    the tails wrote, on the rows, packed (element and row accumulator) and
    fused layouts, while the same K steps outside it train the state."""
    from fast_tffm_tpu_torch.ops.tail import rows_restored
    from fast_tffm_tpu_torch.trainer import k_step_loop

    model, state = _state("fused" if layout == "fused" else "rows")
    if layout.endswith("_row"):
        state.table_accum = state.table_accum[:, :1].contiguous()
    if layout.startswith("packed"):
        state = pack_state(state, 0.1)
    body = train_step_body if layout.startswith("rows") else packed_train_step_body
    run = k_step_loop(model, 0.05, body, lambda i, *f: Batch(*(x[i] for x in f)))
    group = _pairs(3)
    fields = [getattr(Batch.stack_parsed([p for p, _ in group], [w for _, w in group]), f.name)
              for f in dataclasses.fields(Batch)]
    before = _clone(state)
    with rows_restored():
        _, inside = run(dataclasses.replace(state), *fields)  # the live tensors
    _same(state, before)
    trained, outside = run(_clone(before), *fields)
    assert torch.equal(inside, outside)
    assert not torch.equal(trained.table, before.table)
    with rows_restored(), pytest.raises(RuntimeError, match="do not nest"):
        with rows_restored():
            pass


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shuffled", [False, True])
def test_cached_steps_are_bitwise_the_streamed_steps(tmp_path, layout, shuffled):
    src = str(tmp_path / "train.libsvm")
    shutil.copy(TRAIN, src)
    fmb = binary.write_fmb(src, src + ".fmb", vocabulary_size=V)
    kw = dict(batch_size=B, vocabulary_size=V, max_nnz=NNZ, weights=(0.5,))
    seed = binary.fold_epoch_seed(4, 1) if shuffled else None
    pairs = list(binary.fmb_batch_stream([fmb], shuffle_seed=seed, **kw))
    assert len(pairs) == 20  # 400 rows
    model, state = _state(layout, seed=1)
    single = (make_packed_train_step if layout == "fused" else make_train_step)(model, 0.05)
    streamed, want = _clone(state), []
    for parsed, w in pairs:
        streamed, loss = single(streamed, Batch.from_parsed(parsed, w))
        want.append(loss)

    data = device_cache.load_device_dataset([fmb], **kw)
    if shuffled:
        device_cache.set_permutation(data, device_cache.full_epoch_perm(data, 4, 1))
    step, step_shuffled = device_cache.make_cached_train_step(model, 0.05, data, _body(layout))
    one = step_shuffled if shuffled else step
    cached, got = _clone(state), []
    for i in range(data.batches):
        cached, loss = one(cached, torch.tensor(i))
        got.append(loss)
    assert torch.equal(torch.stack(got), torch.stack(want))
    _same(cached, streamed)

    scan, scan_shuffled = device_cache.make_cached_scan_train_step(model, 0.05, data,
                                                                   _body(layout))
    scan = scan_shuffled if shuffled else scan
    got = []
    for idxs in device_cache.epoch_index_chunks(data.batches, 6):  # 6, 6, 6, then 2
        state, losses = scan(state, idxs)
        got.extend(losses)
    assert torch.equal(torch.stack(got), torch.stack(want))
    _same(state, streamed)


def _jax_cfg(**kw):
    return JaxConfig(telemetry_profile_costs=False, **kw).validate()


def _kw(tmp_path, name, **kw):
    """Both packages' settings; the data files are copied into ``tmp_path``,
    where ``binary_cache`` writes their ``.fmb`` caches."""
    for src in (TRAIN, TEST):
        if not (tmp_path / os.path.basename(src)).exists():
            shutil.copy(src, tmp_path)
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        validation_files=(str(tmp_path / "test.libsvm"),), epoch_num=2, batch_size=B, learning_rate=0.05,
        factor_lambda=1e-4, bias_lambda=1e-4, log_every=3, thread_num=2,
    )
    base.update(kw)
    return base


def _losses(lines):
    return [float(s.split()[5]) for s in lines if s.startswith("step ")]


def _aucs(lines):
    return [float(s.split()[-1]) for s in lines if "validation auc" in s]


@pytest.mark.parametrize(
    "mode",
    [
        dict(binary_cache=True, shuffle=True, shuffle_seed=5),
        dict(device_cache=True, binary_cache=True, shuffle=True, shuffle_seed=5,
             steps_per_call=3),
        dict(binary_cache=True, steps_per_call=4, table_layout="packed",
             adagrad_accumulator="fused"),
    ],
    ids=["binary_cache-shuffle", "device_cache-steps3", "steps4-fused"],
)
def test_train_matches_jax_on_the_input_paths(tmp_path, mode):
    kw = _kw(tmp_path, "jax.ckpt", **mode)
    jcfg = _jax_cfg(**kw)
    accumulator = jcfg.adagrad_accumulator
    jstate = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1,
                            "row" if accumulator == "fused" else accumulator)
    table = np.random.default_rng(0).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(jcfg.model_file, jstate._replace(table=jnp.asarray(table)))
    cfg = Config(**dict(kw, model_file=str(tmp_path / "port.ckpt"))).validate()
    shutil.copy(jcfg.model_file, cfg.model_file)
    jlog, log = [], []
    jax_train(jcfg, resume=True, log=jlog.append)
    state = train(cfg, resume=True, log=log.append, device="cpu")
    assert state.step == 40
    got, want = _losses(log), _losses(jlog)
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(_aucs(log), _aucs(jlog), atol=1e-4)
    width = 1 + K if accumulator == "element" else 1
    mine = restore_checkpoint(cfg.model_file, CPU, accum_width=width)
    with np.load(jcfg.model_file) as z:
        np.testing.assert_allclose(mine.table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(mine.table_accum.numpy(), z["table_accum"], atol=1e-5)
    assert not np.allclose(mine.table.numpy(), table)
    if mode.get("device_cache"):
        assert "device cache: 400 rows resident (0.0 MiB, 20 batches/epoch)" in log
    if mode.get("binary_cache"):
        assert os.path.exists(cfg.train_files[0] + ".fmb")


def test_train_logs_and_checks_each_k_step_group(tmp_path):
    """K = 3 over 20 batches: six groups of 3 and one of 2, the log K-step
    aligned; a non-finite loss in a group aborts before any save."""
    kw = _kw(tmp_path, "m.ckpt", steps_per_call=3, epoch_num=1, log_every=4,
             validation_files=())
    log = []
    state = train(Config(**kw).validate(), log=log.append, device="cpu")
    steps = [int(s.split()[1]) for s in log if s.startswith("step ")]
    assert state.step == 20 and steps == [6, 12, 18]
    cfg = Config(**dict(kw, learning_rate=1e30, model_file=str(tmp_path / "nan.ckpt"))).validate()
    from fast_tffm_tpu_torch.training import NonFiniteLossError

    with pytest.raises(NonFiniteLossError):
        train(cfg, log=lambda *_: None, device="cpu")
    assert not os.path.exists(cfg.model_file)


@pytest.mark.parametrize("mode", [{}, dict(device_cache=True, binary_cache=True)],
                         ids=["streamed", "device_cache"])
def test_train_logs_a_rate_when_k_reaches_log_every(tmp_path, mode):
    """K = 4 with log_every = 4: the first log window holds only the first
    call, which the meter does not count, so its line gives the loss and no
    rate; every later line rates its window, and no rate is 0.  With no log
    point before the save, a non-finite group still aborts before it."""
    kw = _kw(tmp_path, "m.ckpt", steps_per_call=4, epoch_num=1, log_every=4,
             validation_files=(), **mode)
    log = []
    train(Config(**kw).validate(), log=log.append, device="cpu")
    lines = [s for s in log if s.startswith("step ")]
    assert [int(s.split()[1]) for s in lines] == [4, 8, 12, 16, 20]
    assert "examples/sec" not in lines[0]
    rates = [float(s.split()[7].replace(",", "")) for s in lines[1:]]
    assert min(rates) > 0
    cfg = Config(**dict(kw, learning_rate=1e30, log_every=1000,
                        model_file=str(tmp_path / "nan.ckpt"))).validate()
    from fast_tffm_tpu_torch.training import NonFiniteLossError

    with pytest.raises(NonFiniteLossError):
        train(cfg, log=lambda *_: None, device="cpu")
    assert not os.path.exists(cfg.model_file)


def test_device_cache_needs_fmb_input(tmp_path):
    cfg = Config(**_kw(tmp_path, "m.ckpt", device_cache=True)).validate()
    with pytest.raises(ValueError, match="device_cache = true needs FMB-backed input"):
        train(cfg, log=lambda *_: None, device="cpu")
    cfg = Config(**_kw(tmp_path, "m.ckpt", shuffle=True)).validate()
    with pytest.raises(Exception, match="shuffle requires memmap"):
        train(cfg, log=lambda *_: None, device="cpu")


@pytest.mark.parametrize("how", ["binary_cache", "fmb_file"])
def test_predict_reads_fmb_like_jax(tmp_path, how):
    """``predict`` over an FMB file, or text with ``binary_cache``: the JAX
    ``predict``'s score file (atol 1e-6, the printed %.6f), one line per
    row."""
    from fast_tffm_tpu.prediction import predict as jax_predict
    from fast_tffm_tpu_torch.prediction import predict

    kw = _kw(tmp_path, "m.ckpt")
    table = np.random.default_rng(3).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    with open(kw["model_file"], "wb") as f:
        np.savez(f, table=table, table_accum=np.full((V, 1 + K), 0.1, np.float32),
                 step=np.int32(0))
    src = kw["validation_files"][0]
    files = (binary.write_fmb(src, str(tmp_path / "p.fmb"), vocabulary_size=V),) if (
        how == "fmb_file") else (src,)
    kw.update(predict_files=files, binary_cache=how == "binary_cache", batch_size=32)
    jcfg = _jax_cfg(**dict(kw, score_path=str(tmp_path / "jax.scores")))
    cfg = Config(**dict(kw, score_path=str(tmp_path / "port.scores"))).validate()
    jax_predict(jcfg, log=lambda *_: None)
    predict(cfg, log=lambda *_: None, device="cpu")
    want, got = np.loadtxt(jcfg.score_path), np.loadtxt(cfg.score_path)
    assert got.shape == want.shape == (120,)
    np.testing.assert_allclose(got, want, atol=1e-6 + 1e-9)
