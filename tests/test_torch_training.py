"""Port: the training path against the JAX package on the CPU.

* Step by step: one JAX state (table drawn from a numpy seed, accumulators
  at their init value) is saved by the JAX ``save_checkpoint``; both
  packages restore it and run the same 20 batches of ``data/train.libsvm``
  through their ``make_train_step`` — JAX with its default CPU tail and with
  ``make_pallas_tail_body(interpret=True)``, the port with its default
  body and ``make_pallas_tail_body`` (the kernel's plain twin on the CPU).
  Per-step losses within rtol 1e-5; final tables and accumulators within
  atol 1e-5 (float32, summation order).
* End to end: ``train(cfg, resume=True, device="cpu")`` and the JAX
  ``train(cfg, resume=True)`` from one npz give the same validation AUC
  (within 1e-4); the port's saved npz restores in the JAX package and
  scores identically (atol 1e-6); the port's ``predict`` and the JAX
  ``predict`` write the same score file (atol 1e-6).
* Quality: on a small baseline5-shaped run (order 3, k = 8, 11 features
  per example, planted FM labels) the port's held-out AUC is within ±0.005
  of ``tests/oracle_trainer.py``'s from the same initial table.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore_checkpoint
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.models.base import Batch as JaxBatch
from fast_tffm_tpu.prediction import load_scoring_state as jax_load_scoring_state
from fast_tffm_tpu.prediction import make_score_fn as jax_make_score_fn
from fast_tffm_tpu.prediction import predict as jax_predict
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.trainer import make_pallas_tail_body as jax_make_pallas_tail_body
from fast_tffm_tpu.trainer import make_train_step as jax_make_train_step
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn, predict
from fast_tffm_tpu_torch.trainer import make_pallas_tail_body, make_train_step
from fast_tffm_tpu_torch.training import train
from tests.oracle_trainer import OracleFMVec, rank_auc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ = 256, 8, 8  # the sample files' ids are < 200, rows <= 8 wide
CPU = torch.device("cpu")


def quiet(*_):
    pass


def _kw(tmp_path, name="m.ckpt", **kw):
    """Settings both packages' Configs take: baseline5's model and
    optimizer keys at a small vocabulary."""
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(TRAIN,), validation_files=(TEST,),
        predict_files=(TEST,), score_path=str(tmp_path / (name + ".scores")),
        epoch_num=1, batch_size=20, learning_rate=0.05, factor_lambda=1e-4,
        bias_lambda=1e-4, log_every=5,
    )
    base.update(kw)
    return base


def _jax_cfg(**kw):
    return JaxConfig(telemetry_profile_costs=False, **kw).validate()


def _shared_npz(kw, accumulator="element", seed=0):
    """A JAX init_state with a table from a numpy seed, saved as npz by the
    JAX package; returns (the JAX config, the JAX state)."""
    jcfg = _jax_cfg(**kw, adagrad_accumulator=accumulator)
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, accumulator)
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    state = state._replace(table=jnp.asarray(table))
    jax_save_checkpoint(jcfg.model_file, state)
    return jcfg, state


def _batches(n=20):
    stream = batch_stream([TRAIN], batch_size=20, vocabulary_size=V, max_nnz=NNZ)
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize(
    "accumulator,tail", [("element", "classic"), ("element", "pallas"), ("row", "pallas")]
)
def test_train_steps_match_jax_step_by_step(tmp_path, accumulator, tail):
    kw = _kw(tmp_path)
    jcfg, _ = _shared_npz(kw, accumulator)
    jmodel = jax_build_model(jcfg)
    jstate = jax_restore_checkpoint(
        jcfg.model_file, jax_init_state(jmodel, jax.random.key(1), 0.1, accumulator)
    )
    jstep = jax_make_train_step(
        jmodel, jcfg.learning_rate,
        body=jax_make_pallas_tail_body(interpret=True) if tail == "pallas" else None,
    )
    cfg = Config(**kw, adagrad_accumulator=accumulator).validate()
    model = build_model(cfg)
    width = 1 + K if accumulator == "element" else 1
    state = restore_checkpoint(cfg.model_file, CPU, accum_width=width)
    step = make_train_step(
        model, cfg.learning_rate, body=make_pallas_tail_body() if tail == "pallas" else None
    )
    jl, tl = [], []
    for parsed, w in _batches():
        jstate, jloss = jstep(jstate, JaxBatch.from_parsed(parsed, w, with_fields=False))
        state, loss = step(state, Batch.from_parsed(parsed, w, CPU))
        jl.append(float(jloss))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert state.step == int(jstate.step) == 20
    np.testing.assert_allclose(state.table.numpy(), np.asarray(jstate.table), atol=1e-5)
    np.testing.assert_allclose(
        state.table_accum.numpy(), np.asarray(jstate.table_opt.accum), atol=1e-5
    )
    assert not np.allclose(state.table.numpy(), np.asarray(jax_restore_checkpoint(
        jcfg.model_file, jax_init_state(jmodel, jax.random.key(1), 0.1, accumulator)).table))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One shared npz, trained for two epochs by each package on the CPU."""
    tmp = tmp_path_factory.mktemp("trained")
    kw = _kw(tmp, "jax.ckpt", epoch_num=2)
    jcfg, _ = _shared_npz(kw)
    cfg = Config(**dict(kw, model_file=str(tmp / "port.ckpt"),
                        score_path=str(tmp / "port.scores"))).validate()
    shutil.copy(jcfg.model_file, cfg.model_file)
    jlog, log = [], []
    jax_train(jcfg, resume=True, log=jlog.append)
    state = train(cfg, resume=True, log=log.append, device="cpu")
    return jcfg, cfg, jlog, log, state


def _aucs(lines):
    return [float(s.split()[-1]) for s in lines if "validation auc" in s]


def test_train_validation_auc_matches_jax(trained):
    jcfg, cfg, jlog, log, state = trained
    assert state.step == 40
    got, want = _aucs(log), _aucs(jlog)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert any(s.startswith("step 5 epoch 0 loss ") and "examples/sec" in s for s in log)
    assert log[-1] == f"training done: steps 0->40, model -> {cfg.model_file}"


def test_port_checkpoint_restores_and_scores_in_jax(trained):
    jcfg, cfg, _, _, state = trained
    jcfg_port = dataclasses.replace(jcfg, model_file=cfg.model_file)
    jmodel, jstate = jax_load_scoring_state(jcfg_port, quiet)
    assert int(jstate.step) == state.step
    np.testing.assert_array_equal(np.asarray(jstate.table), state.table.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.table_opt.accum), state.table_accum.numpy())
    parsed, w = _batches(1)[0]
    want = np.asarray(jax_make_score_fn(jcfg_port, jstate, NNZ, model=jmodel)(
        jstate, JaxBatch.from_parsed(parsed, w, with_fields=False)))
    model, pstate = load_scoring_state(cfg, quiet, device="cpu")
    got = make_score_fn(cfg, pstate, NNZ, model=model)(pstate, Batch.from_parsed(parsed, w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_predict_writes_the_jax_score_file(trained):
    jcfg, cfg, _, _, _ = trained
    jcfg_port = dataclasses.replace(
        jcfg, model_file=cfg.model_file, score_path=cfg.score_path + ".jax"
    )
    jax_predict(jcfg_port, log=quiet)
    predict(cfg, log=quiet, device="cpu")
    want = np.loadtxt(jcfg_port.score_path)
    got = np.loadtxt(cfg.score_path)
    assert got.shape == want.shape == (120,)
    np.testing.assert_allclose(got, want, atol=1e-6 + 1e-9)


def test_save_checkpoint_round_trip_and_accumulator_refusal(tmp_path):
    kw = _kw(tmp_path)
    _shared_npz(kw, "row")
    state = restore_checkpoint(kw["model_file"], CPU, accum_width=1)
    path = str(tmp_path / "again.ckpt")
    open(path + ".delta-0001.npz", "wb").close()
    save_checkpoint(path, state, chunk_bytes=100)  # many chunks per member
    assert not os.path.exists(path + ".delta-0001.npz") and not os.path.exists(path + ".tmp")
    again = restore_checkpoint(path, CPU, accum_width=1)
    assert torch.equal(again.table, state.table) and torch.equal(again.table_accum, state.table_accum)
    with np.load(path) as z:
        assert set(z.files) == {"table", "table_accum", "step", "save_id", "published_at"}
        assert z["step"].dtype == np.int32
    with pytest.raises(ValueError, match="adagrad_accumulator = row"):
        restore_checkpoint(path, CPU, accum_width=1 + K)


def _planted(rng, n, vocab, planted):
    """n rows of 11 distinct ids with values in (0, 1]; labels from the
    planted FM's scores."""
    ids = np.stack([rng.choice(vocab, size=11, replace=False) for _ in range(n)])
    vals = np.round(rng.uniform(0.05, 1.0, size=(n, 11)), 4)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-planted.score(ids, vals)))).astype(np.int64)
    text = "".join(
        f"{y[r]} " + " ".join(f"{i}:{v}" for i, v in zip(ids[r], vals[r])) + "\n"
        for r in range(n)
    )
    return y, ids, vals, text


def test_trained_auc_matches_the_numpy_oracle(tmp_path):
    vocab, lr, epochs, batch = 1000, 0.2, 2, 200
    rng = np.random.default_rng(29)
    planted = OracleFMVec(vocab, K, order=3, seed=99)
    planted.w = rng.normal(scale=0.8, size=vocab)
    planted.v = rng.normal(scale=0.25, size=(vocab, K))
    y_tr, id_tr, v_tr, text_tr = _planted(rng, 4000, vocab, planted)
    y_te, id_te, v_te, text_te = _planted(rng, 1000, vocab, planted)
    (tmp_path / "tr.libsvm").write_text(text_tr)
    (tmp_path / "te.libsvm").write_text(text_te)

    table = np.zeros((vocab, 1 + K), np.float32)
    table[:, 1:] = rng.uniform(-0.05, 0.05, size=(vocab, K))
    oracle = OracleFMVec(vocab, K, order=3, seed=1, factor_lambda=1e-7, bias_lambda=1e-7)
    oracle.w = table[:, 0].astype(np.float64)
    oracle.v = table[:, 1:].astype(np.float64)
    for _ in range(epochs):
        oracle.train_epoch(y_tr, id_tr, v_tr, None, batch_size=batch, lr=lr)
    auc_o = rank_auc(list(y_te), list(oracle.predict(id_te, v_te)))

    cfg = Config(
        model="fm", order=3, factor_num=K, vocabulary_size=vocab, max_nnz=11,
        model_file=str(tmp_path / "m.ckpt"), train_files=(str(tmp_path / "tr.libsvm"),),
        validation_files=(str(tmp_path / "te.libsvm"),), epoch_num=epochs, batch_size=batch,
        learning_rate=lr, factor_lambda=1e-7, bias_lambda=1e-7, log_every=1000,
    ).validate()
    with open(cfg.model_file, "wb") as f:
        np.savez(f, table=table, table_accum=np.full((vocab, 1 + K), 0.1, np.float32),
                 step=np.int32(0))
    log = []
    train(cfg, resume=True, log=log.append, device="cpu")
    auc_t = _aucs(log)[-1]
    assert auc_o > 0.6, auc_o
    assert abs(auc_t - auc_o) < 0.005, (auc_t, auc_o)
