"""Port: the packed and fused layouts and kernel B3's twin against the JAX package.

* Layouts, bitwise: ``pack_table``, ``unpack_table``, ``packed_gather``,
  ``pack_fused``, ``unpack_fused`` and ``fused_gather`` of the port and of
  ``fast_tffm_tpu/ops/packed_table.py`` on one numpy input, over D in
  {3, 7, 9, 64} (D+1 = 8 divides 128; baseline5's D = 9 leaves pad lanes;
  D = 64 gives the fused layout P = 1), V not a multiple of P, ids that
  include V−1 and two slots of one tile row.
* B3's twin (``ops/tail.fused_tail_adagrad_update`` on a CPU tensor):
  within rtol 1e-6 of the JAX fused Pallas tail (interpret mode) and of
  ``apply_fused_update(..., "dense")``, which sum ‖g‖² in another order
  (1–2 ulp); bitwise equal, after unpacking, to the port's rows update with
  a [V, 1] accumulator, with untouched slots, pad slots and tail lanes
  unchanged, at every ``k_cap``.  The twin on the kernel's own input (the
  stable sort's output) over unsorted duplicates, a hot id 0 with 10,000+
  occurrences, ids out of range and K = 1: bitwise the dedup twin and the
  rows row update, within rtol 1e-6 of the JAX fused tail.
* Training: the JAX packed + fused step (``tail = "pallas"``, interpret)
  and the port's from one shared npz, 3 steps at order 2 and 3 (losses
  within rtol 1e-5, unpacked tables and accumulators within atol 1e-5);
  the port's packed + fused run bitwise equal to its rows + row run.
* End to end: ``training.train`` on a packed + fused config writes the
  logical npz the JAX package restores; resume from a row checkpoint, refuse
  an element one; ``predict`` and ``serve_lines`` on a packed config score
  as the rows config does and within 1e-6 of the JAX package.
* Config: the JAX package's layout checks, message for message.
"""

import dataclasses
import io
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu import trainer as jax_trainer
from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore_checkpoint
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.models.base import Batch as JaxBatch
from fast_tffm_tpu.ops import packed_table as jpt
from fast_tffm_tpu.ops.pallas_tail import fused_tail_adagrad_update as jax_fused_tail
from fast_tffm_tpu.prediction import predict as jax_predict
from fast_tffm_tpu.serving import serve_lines as jax_serve_lines
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.ops import packed_table as pt
from fast_tffm_tpu_torch.ops.tail import (
    fused_adagrad_plain,
    fused_tail_adagrad_update,
    fused_tail_sorted_plain,
)
from fast_tffm_tpu_torch.optim import dedup_rows, sparse_adagrad_update
from fast_tffm_tpu_torch.prediction import load_scoring_state, predict
from fast_tffm_tpu_torch.serving.engine import serve_lines
from fast_tffm_tpu_torch.trainer import (
    make_packed_train_step,
    make_train_step,
    pack_state,
    unpack_state,
)
from fast_tffm_tpu_torch.training import train
from fast_tffm_tpu_torch.weights import from_jax_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ = 250, 8, 8  # the sample files' ids are < 200; 250 % 12 = 10 (fused P at D = 9)
CPU = torch.device("cpu")
LR = 0.13


def quiet(*_):
    pass


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _layout_case(d, seed=0):
    """A [V, D] table and [V, 1] accumulator, V not a multiple of either P,
    and ids with V−1 and two slots of one tile row."""
    p = jpt.fused_rows_per_tile(d)
    v = 5 * max(p, jpt.rows_per_tile(d)) + 3
    rng = np.random.default_rng(seed + d)
    table = rng.normal(size=(v, d)).astype(np.float32)
    accum = rng.uniform(0.05, 2.0, (v, 1)).astype(np.float32)
    ids = np.concatenate([[v - 1, 0, 1, p, p + 1], rng.integers(0, v, 11)]).astype(np.int32)
    return v, table, accum, ids.reshape(2, 8)


@pytest.mark.parametrize("d", [3, 7, 9, 64])
def test_pack_and_unpack_table_match_jax_bitwise(d):
    v, table, _, _ = _layout_case(d)
    want = np.asarray(jpt.pack_table(jnp.asarray(table)))
    got = pt.pack_table(_t(table))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (pt.packed_rows(v, d), pt.LANES)
    np.testing.assert_array_equal(
        pt.unpack_table(got, v, d).numpy(), np.asarray(jpt.unpack_table(jnp.asarray(want), v, d))
    )
    np.testing.assert_array_equal(pt.unpack_table(got, v, d).numpy(), table)


@pytest.mark.parametrize("d", [3, 7, 9, 64])
def test_pack_and_unpack_fused_match_jax_bitwise(d):
    v, table, accum, _ = _layout_case(d)
    want = np.asarray(jpt.pack_fused(jnp.asarray(table), jnp.asarray(accum), 0.1))
    got = pt.pack_fused(_t(table), _t(accum), 0.1)
    np.testing.assert_array_equal(got.numpy(), want)
    p = pt.fused_rows_per_tile(d)
    assert got.shape == (pt.fused_packed_rows(v, d), pt.LANES)
    tail = got[:, p * (d + 1):]
    assert bool((tail == np.float32(0.1)).all())  # tail lanes carry init_value
    jt, ja = jpt.unpack_fused(jnp.asarray(want), v, d)
    gt, ga = pt.unpack_fused(got, v, d)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(gt.numpy(), table)
    np.testing.assert_array_equal(ga.numpy(), accum)


@pytest.mark.parametrize("d", [3, 7, 9, 64])
def test_gathers_match_jax_bitwise(d):
    v, table, accum, ids = _layout_case(d)
    packed = jpt.pack_table(jnp.asarray(table))
    fused = jpt.pack_fused(jnp.asarray(table), jnp.asarray(accum), 0.1)
    got = pt.packed_gather(_t(packed), _t(ids), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpt.packed_gather(packed, jnp.asarray(ids), d)))
    got = pt.fused_gather(_t(fused), _t(ids), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpt.fused_gather(fused, jnp.asarray(ids), d)))
    np.testing.assert_array_equal(got.numpy(), table[ids])


# ---------------------------------------------------------------------------
# kernel B3's twin
# ---------------------------------------------------------------------------


def _tail_case(seed, m):
    """Ids with duplicates (m draws from 64 rows), gradients, and a fused
    array packed from a [V, 9] table and [V, 1] accumulator."""
    rng = np.random.default_rng(seed)
    d = 1 + K
    ids = rng.integers(0, 64, size=(m,)).astype(np.int32)
    ids[: min(m, 3)] = [V - 1, 12, 13][: min(m, 3)]  # the last row; two slots of tile row 1
    g = rng.standard_normal((m, d)).astype(np.float32)
    table = rng.standard_normal((V, d)).astype(np.float32)
    accum = rng.uniform(0.05, 2.0, (V, 1)).astype(np.float32)
    return ids, g, table, accum


@pytest.mark.parametrize(
    "decay,m", [(1.0, 40), (0.9, 40), (1.0, 1)], ids=["dup-ids", "decay-0.9", "K=1"]
)
def test_fused_twin_matches_the_jax_fused_tails(decay, m):
    ids, g, table, accum = _tail_case(m, m)
    d = 1 + K
    jfused = jpt.pack_fused(jnp.asarray(table), jnp.asarray(accum), 0.1)
    want = [jax.jit(lambda f: jax_fused_tail(
        f, jnp.asarray(ids), jnp.asarray(g), LR, decay=decay, interpret=True))(jfused)]
    if decay == 1.0:
        want.append(jax.jit(lambda f: jpt.apply_fused_update(
            f, jnp.asarray(ids), jnp.asarray(g), LR, "dense"))(jfused))
    got = fused_tail_adagrad_update(_t(np.asarray(jfused)).clone(), _t(ids), _t(g), LR, decay=decay)
    gt, ga = pt.unpack_fused(got, V, d)
    # At γ < 1 XLA also contracts γ·acc + ‖g‖² into one fma, and the 1–2 ulp
    # of acc2 reach w − lr·g/√acc2 where it cancels near 0 (seen: 3.7e-9 at
    # |w| = 1.9e-3, from |w|, |lr·g/√acc| ~ 0.5): an atol of 1e-8 there.
    table_atol = 0.0 if decay == 1.0 else 1e-8
    for w in want:
        wt, wa = jpt.unpack_fused(w, V, d)
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-6, atol=table_atol)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6, atol=0)
        assert not np.array_equal(np.asarray(wt), table)  # the update moved the table


@pytest.mark.parametrize("k_cap", [0, 1, "K+5"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_fused_twin_is_bitwise_the_rows_row_update(decay, k_cap):
    ids, g, table, accum = _tail_case(7, 40)
    d = 1 + K
    k = len(np.unique(ids))
    cap = k + 5 if k_cap == "K+5" else k_cap
    fused = pt.pack_fused(_t(table), _t(accum), 0.1)
    got = fused_tail_adagrad_update(fused.clone(), _t(ids), _t(g), LR, decay=decay, k_cap=cap)
    t_r, a_r = sparse_adagrad_update(_t(table).clone(), _t(accum).clone(), _t(ids), _t(g), LR, decay)
    gt, ga = pt.unpack_fused(got, V, d)
    assert torch.equal(gt, t_r) and torch.equal(ga, a_r)
    # Untouched slots, pad slots and tail lanes are bitwise unchanged.
    p = pt.fused_rows_per_tile(d)
    touched = np.zeros(got.shape, bool)
    for u in np.unique(ids):
        touched[u // p, (u % p) * (d + 1):(u % p + 1) * (d + 1)] = True
    assert torch.equal(got[_t(~touched)], fused[_t(~touched)])
    assert not torch.equal(got, fused)
    with pytest.raises(ValueError, match="k_cap"):
        fused_tail_adagrad_update(fused, _t(ids), _t(g), LR, k_cap=-1)


@pytest.mark.parametrize("pattern", ["dups", "hot", "out of range", "K=1"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_fused_sorted_twin_is_bitwise_the_dedup_twin_and_matches_jax(decay, pattern):
    """B3's twin on the kernel's own input — the stable sort's output
    through ``sorted_segment_sum``, then ``fused_adagrad_plain`` — is bitwise
    ``fused_adagrad_plain`` on ``dedup_rows`` output and, unpacked, the rows
    row update; within the existing tolerances of the JAX fused tail.
    "hot": id 0 10,000+ times among unsorted duplicates; "out of range":
    ids past VPf·P, which every tail skips."""
    rng = np.random.default_rng(len(pattern))
    d = 1 + K
    vmax = pt.fused_packed_rows(V, d) * pt.fused_rows_per_tile(d)
    if pattern == "hot":
        ids = np.zeros(10_400, np.int32)
        ids[rng.choice(10_400, 400, replace=False)] = rng.integers(1, V, 400)
    elif pattern == "out of range":
        ids = rng.integers(0, vmax + 30, size=400).astype(np.int32)
    elif pattern == "dups":
        ids = rng.integers(0, 64, size=400).astype(np.int32)
    else:
        ids = np.array([V - 1], np.int32)
    g = rng.standard_normal((ids.size, d)).astype(np.float32)
    table = rng.standard_normal((V, d)).astype(np.float32)
    accum = rng.uniform(0.05, 2.0, (V, 1)).astype(np.float32)
    fused = pt.pack_fused(_t(table), _t(accum), 0.1)
    sid, order = torch.sort(_t(ids), stable=True)
    got = fused_tail_sorted_plain(fused.clone(), sid, order, _t(g), LR, decay)
    assert torch.equal(got, fused_adagrad_plain(fused.clone(), *dedup_rows(_t(ids), _t(g)), LR, decay))
    assert torch.equal(got, fused_tail_adagrad_update(fused.clone(), _t(ids), _t(g), LR, decay=decay))
    t_r, a_r = sparse_adagrad_update(_t(table), _t(accum), _t(ids), _t(g), LR, decay)
    gt, ga = pt.unpack_fused(got, V, d)
    assert torch.equal(gt, t_r) and torch.equal(ga, a_r)
    want = jax.jit(lambda f: jax_fused_tail(
        f, jnp.asarray(ids), jnp.asarray(g), LR, decay=decay, interpret=True, block_rows=4096,
    ))(jpt.pack_fused(jnp.asarray(table), jnp.asarray(accum), 0.1))
    wt, wa = jpt.unpack_fused(want, V, d)
    # The JAX fused tail's ‖g‖² is 1–2 ulp off at either γ (ROADMAP §C
    # caveat 1), and w − lr·g/√acc2 cancels near 0 for some of 400 draws
    # (seen: 7.5e-9 at γ = 1): the table's atol of 1e-8, as above.
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-6, atol=0)
    # The pad slots past V are rows too (the JAX tail writes them as well).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)
    assert not torch.equal(got, fused)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _kw(tmp_path, name="m.ckpt", **kw):
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(TRAIN,), validation_files=(TEST,),
        predict_files=(TEST,), score_path=str(tmp_path / (name + ".scores")),
        epoch_num=1, batch_size=20, learning_rate=0.05, factor_lambda=1e-4,
        bias_lambda=1e-4, log_every=5, table_layout="packed", adagrad_accumulator="fused",
    )
    base.update(kw)
    return base


def _shared_npz(kw, seed=0):
    """A JAX rows state with a table from a numpy seed and a [V, 1]
    accumulator, saved as npz by the JAX package."""
    jcfg = JaxConfig(telemetry_profile_costs=False, **kw).validate()
    state = jax_trainer.init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, "row")
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(jcfg.model_file, state._replace(table=jnp.asarray(table)))
    return jcfg


def _batches(n):
    stream = batch_stream([TRAIN], batch_size=20, vocabulary_size=V, max_nnz=NNZ)
    return [next(stream) for _ in range(n)]


@pytest.mark.parametrize("order", [2, 3])
def test_packed_fused_steps_match_jax_step_by_step(tmp_path, order):
    kw = _kw(tmp_path, order=order)
    jcfg = _shared_npz(kw)
    jmodel = jax_build_model(jcfg)
    jstate = jax_trainer.pack_state(
        jax_restore_checkpoint(jcfg.model_file,
                               jax_trainer.init_state(jmodel, jax.random.key(1), 0.1, "fused")),
        0.1, fused=True,
    )
    jstep = jax_trainer.make_packed_train_step(jmodel, jcfg.learning_rate, tail="pallas")
    cfg = Config(**kw).validate()
    model = build_model(cfg)
    state = pack_state(restore_checkpoint(cfg.model_file, CPU, accum_width=1), 0.1, fused=True)
    # The JAX fused state carries across whole, and packs as the port's does.
    carried = from_jax_arrays(np.asarray(jstate.table), [], jstate.step, CPU,
                              table_accum=np.asarray(jstate.table_opt.accum), layout="fused")
    assert carried.layout == state.layout == "fused" and torch.equal(carried.table, state.table)
    step = make_packed_train_step(model, cfg.learning_rate)
    jl, tl = [], []
    for parsed, w in _batches(3):
        jstate, jloss = jstep(jstate, JaxBatch.from_parsed(parsed, w, with_fields=False))
        state, loss = step(state, Batch.from_parsed(parsed, w, CPU))
        jl.append(float(jloss))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert state.step == int(jstate.step) == 3
    jt, ja = jpt.unpack_fused(jstate.table, V, 1 + K)
    got = unpack_state(state, model)
    np.testing.assert_allclose(got.table.numpy(), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(got.table_accum.numpy(), np.asarray(ja), atol=1e-5)
    assert not np.allclose(got.table.numpy(), restore_checkpoint(cfg.model_file, CPU).table.numpy())


def test_packed_fused_and_rows_row_runs_are_bitwise_equal(tmp_path):
    kw = _kw(tmp_path)
    _shared_npz(kw)
    cfg = Config(**kw).validate()
    model = build_model(cfg)
    rows = restore_checkpoint(cfg.model_file, CPU, accum_width=1)
    fused = pack_state(restore_checkpoint(cfg.model_file, CPU, accum_width=1), 0.1, fused=True)
    rows_step = make_train_step(model, cfg.learning_rate)
    fused_step = make_packed_train_step(model, cfg.learning_rate)
    for parsed, w in _batches(3):
        rows, rl = rows_step(rows, Batch.from_parsed(parsed, w, CPU))
        fused, fl = fused_step(fused, Batch.from_parsed(parsed, w, CPU))
        assert torch.equal(rl, fl)
    got = unpack_state(fused, model)
    assert torch.equal(got.table, rows.table) and torch.equal(got.table_accum, rows.table_accum)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A packed + fused run of ``training.train`` from one shared npz."""
    tmp = tmp_path_factory.mktemp("packed")
    kw = _kw(tmp, "fused.ckpt")
    jcfg = _shared_npz(kw)
    shutil.copy(jcfg.model_file, str(tmp / "init.ckpt"))
    cfg = Config(**kw).validate()
    log = []
    state = train(cfg, resume=True, log=log.append, device="cpu")
    return tmp, jcfg, cfg, log, state


def test_train_saves_logical_arrays_the_jax_package_restores(trained):
    tmp, jcfg, cfg, log, state = trained
    assert state.layout == "fused" and state.step == 20
    assert "sparse tail: fused_tail_adagrad (fused one-pass gather→Adagrad→scatter)" in log
    assert any(s.startswith("resumed from") and s.endswith("(packed)") for s in log)
    assert any(s.startswith("epoch 0 validation auc ") for s in log)
    with np.load(cfg.model_file) as z:
        assert z["table"].shape == (V, 1 + K) and z["table_accum"].shape == (V, 1)
    jstate = jax_restore_checkpoint(
        cfg.model_file,
        jax_trainer.init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, "fused"),
    )
    logical = unpack_state(state, build_model(cfg))
    np.testing.assert_array_equal(np.asarray(jstate.table), logical.table.numpy())
    np.testing.assert_array_equal(np.asarray(jstate.table_opt.accum), logical.table_accum.numpy())
    assert int(jstate.step) == 20


def test_train_resumes_a_row_checkpoint_and_refuses_an_element_one(tmp_path, trained):
    tmp, _, _, _, fused_state = trained
    kw = _kw(tmp_path)
    shutil.copy(str(tmp / "init.ckpt"), kw["model_file"])  # a rows-layout [V, 1] save
    rows_cfg = Config(**dict(kw, table_layout="rows", adagrad_accumulator="row")).validate()
    rows_state = train(rows_cfg, resume=True, log=quiet, device="cpu")
    model = build_model(rows_cfg)
    got = unpack_state(fused_state, model)
    assert torch.equal(got.table, rows_state.table)
    assert torch.equal(got.table_accum, rows_state.table_accum)
    # The rows run's checkpoint resumes in a fused run.
    cfg = Config(**dict(kw, epoch_num=1)).validate()
    state = train(cfg, resume=True, log=quiet, device="cpu")
    assert state.layout == "fused" and state.step == 40
    with open(kw["model_file"], "wb") as f:
        np.savez(f, table=np.zeros((V, 1 + K), np.float32),
                 table_accum=np.full((V, 1 + K), 0.1, np.float32), step=np.int32(0))
    with pytest.raises(ValueError, match="adagrad_accumulator = element"):
        train(cfg, resume=True, log=quiet, device="cpu")


def test_predict_on_a_packed_config_matches_rows_and_jax(trained):
    _, jcfg, cfg, _, _ = trained
    paths = {}
    for name, c in (("packed", cfg), ("rows", dataclasses.replace(
            cfg, table_layout="rows", adagrad_accumulator="row"))):
        paths[name] = c.score_path + "." + name
        predict(dataclasses.replace(c, score_path=paths[name]), log=quiet, device="cpu")
    _, scoring = load_scoring_state(cfg, quiet, device="cpu")
    assert scoring.layout == "packed" and scoring.table.shape == (pt.packed_rows(V, 1 + K), 128)
    jpath = cfg.score_path + ".jax"
    jax_predict(dataclasses.replace(jcfg, score_path=jpath), log=quiet)
    got, rows, want = (np.loadtxt(p) for p in (paths["packed"], paths["rows"], jpath))
    assert got.shape == want.shape == (120,)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_allclose(got, want, atol=1e-6 + 1e-9)


@pytest.mark.parametrize("accumulator", ["fused", "element"])
def test_serve_on_a_packed_config_matches_rows_and_jax(tmp_path, trained, accumulator):
    """Serving only gathers, so it takes a packed config of any accumulator
    (train refuses the element one)."""
    _, jcfg, cfg, _, _ = trained
    with np.load(cfg.model_file) as z:
        table = z["table"]
    width = 1 if accumulator == "fused" else 1 + K
    model_file = str(tmp_path / f"{accumulator}.ckpt")
    with open(model_file, "wb") as f:  # the JAX restore checks the accumulator's width
        np.savez(f, table=table, table_accum=np.full((V, width), 0.1, np.float32),
                 step=np.int32(20))
    rng = np.random.default_rng(3)
    lines = [
        f"{rng.integers(0, 2)} " + " ".join(
            f"{i}:{v:.4f}" for i, v in zip(rng.choice(V, 6, replace=False), rng.uniform(0.1, 1, 6)))
        for _ in range(30)
    ]
    settings = dict(model_file=model_file, adagrad_accumulator=accumulator,
                    serve_buckets=(1, 8, 32))
    packed = dataclasses.replace(cfg, **settings).validate()
    outs = {}
    for name, c in (("packed", packed), ("rows", dataclasses.replace(
            packed, table_layout="rows", adagrad_accumulator="row"))):
        outs[name] = io.StringIO()
        serve_lines(c.validate(), lines, out=outs[name], log=quiet, device="cpu")
    jout = io.StringIO()
    jax_serve_lines(dataclasses.replace(jcfg, **settings).validate(), lines, out=jout, log=quiet)
    got, rows, want = (np.array(o.getvalue().split(), np.float64)
                       for o in (outs["packed"], outs["rows"], jout))
    assert got.shape == want.shape == (30,)
    np.testing.assert_array_equal(got, rows)
    np.testing.assert_allclose(got, want, atol=1e-6 + 1e-9)


def test_cli_trains_predicts_and_serves_a_packed_fused_config(tmp_path):
    cfg = tmp_path / "fused.cfg"
    cfg.write_text(
        f"[General]\norder = 3\nfactor_num = 4\nvocabulary_size = 256\n"
        f"table_layout = packed\nmodel_file = {tmp_path / 'm.ckpt'}\n"
        f"[Train]\ntrain_files = {TRAIN}\nbatch_size = 100\nlog_every = 2\n"
        "adagrad_accumulator = fused\npacked_compact_cap = 64\n"
        f"[Predict]\npredict_files = {TEST}\nscore_path = {tmp_path / 's.txt'}\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    cli = [sys.executable, "-m", "fast_tffm_tpu_torch.cli"]

    def run(*args, **kw):
        return subprocess.run([*cli, *args, str(cfg), "--device", "cpu"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120, **kw)

    r = run("train")
    assert r.returncode == 0, r.stderr
    assert "sparse tail: fused_tail_adagrad" in r.stderr and "steps 0->4" in r.stderr
    r = run("train", "--resume")
    assert r.returncode == 0 and "at step 4 (packed)" in r.stderr, r.stderr
    with np.load(tmp_path / "m.ckpt") as z:
        assert z["table"].shape == (256, 5) and z["table_accum"].shape == (256, 1)
    r = run("predict")
    assert r.returncode == 0, r.stderr
    scores = np.loadtxt(tmp_path / "s.txt")
    assert scores.shape == (120,) and ((scores > 0) & (scores < 1)).all()
    r = run("serve", input="1 1:0.5 2:1.0 3:0.25\n0 7:1\n")
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.split()) == 2


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

_PF = dict(table_layout="packed", adagrad_accumulator="fused")


@pytest.mark.parametrize(
    "kw",
    [
        dict(adagrad_accumulator="fused"),
        dict(packed_compact_cap=-1),
        dict(table_layout="packed", packed_compact_cap=64),
        dict(_PF, online_adagrad_decay=0.9),
        dict(table_layout="packed", adagrad_accumulator="row", online_adagrad_decay=0.9),
        dict(_PF, online_accum_restart_steps=10),
        dict(packed_update="xyz"),
        dict(packed_update="dense"),
        dict(_PF, packed_update="sorted"),
        dict(table_layout="packed", adagrad_accumulator="row", packed_update="sorted"),
        dict(table_layout="packed", tail="pallas"),
        dict(table_layout="tiles"),
    ],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()),
)
def test_layout_checks_refuse_as_jax_does(kw):
    with pytest.raises(ValueError) as want:
        JaxConfig(telemetry_profile_costs=False, **kw).validate()
    with pytest.raises(ValueError) as got:
        Config(**kw).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(table_layout="packed"),
        dict(table_layout="packed", adagrad_accumulator="row", packed_update="compact"),
        dict(_PF, packed_update="compact", packed_compact_cap=64, tail="pallas"),
    ],
    ids=["packed-element", "packed-row-compact", "fused-capped-pallas"],
)
def test_layout_settings_jax_accepts_validate(kw):
    JaxConfig(telemetry_profile_costs=False, **kw).validate()
    cfg = Config(**kw).validate()
    assert (cfg.table_layout, cfg.packed_compact_cap) == (kw["table_layout"], kw.get(
        "packed_compact_cap", 0))
