"""Port: the packed element/row tails and ``dedup_gather_rows``, against
the JAX package, on the CPU.

* The packed update (``ops/tail.rows_tail_adagrad_update(packed=True)``,
  kernel B4 at the packed address on the card, its twin here) against the JAX XLA
  tails ``packed_sparse_adagrad_update`` (element only),
  ``packed_dense_adagrad_update`` and ``packed_compact_adagrad_update``
  on shared inputs with duplicate ids, zero-gradient padding occurrences
  of id 0 and drop sentinels (ids >= VP·P): bitwise (``np.array_equal``)
  for the element accumulator.  With the row accumulator JAX sums ‖g‖²
  with ``jnp.sum`` in an order of its own (which can change from one
  process to the next), 1–2 ulp off the row-mode update's left-to-right
  sum (ROADMAP caveat C-1, the fused tails' case), so those are held at
  rtol 1e-6 (bitwise only at D = 1, a one-term sum); the port's packed
  row update is held bitwise to its own rows-layout row update instead.
* The packed twin, unpacked, is bitwise the rows twin at D = 1, 9, 64, 89.
* Packing: ``pack_accum_any`` / ``unpack_accum_any`` bitwise the JAX
  ones; a packed state round-trips through ``unpack_state``, the npz save
  and ``pack_state``.
* ``train`` with ``dedup_gather_rows`` is bitwise the plain run at K = 1
  and K = 2 and logs that the port gathers directly; a cap below a
  batch's unique count raises, naming ``dedup_gather_rows``.
* ``train`` on packed element/row configs against the JAX ``train`` from
  one npz: the printed losses within 1e-5, the final arrays within atol
  1e-5 (float32 summation order), as tests/test_torch_training.py holds
  the rows runs; and bitwise the port's own rows run.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_tffm_tpu.ops.packed_table as jpt
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.ops import packed_table as pt
from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update
from fast_tffm_tpu_torch.optim import sparse_adagrad_update
from fast_tffm_tpu_torch.trainer import (
    TrainState,
    init_packed_state,
    init_state,
    pack_state,
    packed_train_step_body,
    train_step_body,
    unpack_state,
)
from fast_tffm_tpu_torch.training import train
from fast_tffm_tpu_torch.utils.prefetch import PrefetchError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20
CPU = torch.device("cpu")
DS = [1, 3, 9, 64, 89]


def quiet(*_):
    pass


def _logical_case(d, accumulator, seed=0, vocab=300, m=96):
    """A seeded logical table and accumulator, and one batch of ids (with
    duplicates, zero-gradient padding occurrences of id 0 and two drop
    sentinels past the packed rows) and its gradient rows."""
    rng = np.random.default_rng(seed + d)
    table = rng.uniform(-0.5, 0.5, (vocab, d)).astype(np.float32)
    accum = rng.uniform(0.1, 0.5, (vocab, d if accumulator == "element" else 1)).astype(np.float32)
    ids = rng.integers(0, vocab, m).astype(np.int32)
    ids[: m // 4] = ids[m // 4 : m // 2]  # duplicates
    grads = rng.normal(0, 0.3, (m, d)).astype(np.float32)
    ids[-6:-2], grads[-6:-2] = 0, 0.0  # padding slots: id 0, no gradient
    vp_p = pt.packed_rows(vocab, d) * pt.rows_per_tile(d)
    ids[-2:] = [vp_p, vp_p + 7]  # drop sentinels
    return table, accum, ids, grads


def _packed(table, accum, d):
    tp = pt.pack_table(torch.from_numpy(table))
    ap = pt.pack_accum_any(torch.from_numpy(accum), d, 0.1)
    return tp, ap


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("accumulator", ["element", "row"])
@pytest.mark.parametrize("strategy", ["sorted", "dense", "compact"])
def test_packed_update_matches_the_jax_packed_tails(d, accumulator, strategy):
    if strategy == "sorted" and accumulator == "row":
        with pytest.raises(ValueError, match="element accumulator"):
            jpt.resolve_packed_update("sorted", 8, 1)
        return
    table, accum, ids, grads = _logical_case(d, accumulator)
    tp, ap = _packed(table, accum, d)
    jfn = jpt.PACKED_UPDATE_FNS[strategy]
    # JAX gets copies and finishes before the port updates tp and ap in
    # place: jnp.asarray may alias a host buffer, and dispatch is async.
    jt, ja = jax.block_until_ready(jfn(
        jnp.asarray(tp.numpy().copy()), jnp.asarray(ap.numpy().copy()), jnp.asarray(ids),
        jnp.asarray(grads), 0.05))
    rows_tail_adagrad_update(tp, ap, torch.from_numpy(ids), torch.from_numpy(grads), 0.05,
                             packed=True)
    if accumulator == "element" or d == 1:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ap.numpy(), np.asarray(ja))
    else:  # jnp.sum's order for ‖g‖² (caveat C-1): 1–2 ulp
        np.testing.assert_allclose(tp.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ap.numpy(), np.asarray(ja), rtol=1e-6)
    assert not np.array_equal(tp.numpy(), _packed(table, accum, d)[0].numpy())


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("accumulator", ["element", "row"])
@pytest.mark.parametrize("decay", [1.0, 0.9])
def test_packed_twin_is_bitwise_the_rows_update(d, accumulator, decay):
    table, accum, ids, grads = _logical_case(d, accumulator, seed=1)
    tp, ap = _packed(table, accum, d)
    keep = ids < 300  # the rows layout's bound is V: drop the sentinels there
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    sparse_adagrad_update(t, a, torch.from_numpy(ids[keep]), torch.from_numpy(grads[keep]), 0.05,
                          decay)
    rows_tail_adagrad_update(tp, ap, torch.from_numpy(ids), torch.from_numpy(grads), 0.05,
                             decay=decay, packed=True)
    assert torch.equal(pt.unpack_table(tp, 300, d), t)
    assert torch.equal(pt.unpack_accum_any(ap, 300, d), a)
    # The rows kernel's wrapper, on the same rows, agrees.
    t2, a2 = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    rows_tail_adagrad_update(t2, a2, torch.from_numpy(ids[keep]), torch.from_numpy(grads[keep]),
                             0.05, decay=decay)
    assert torch.equal(t2, t) and torch.equal(a2, a)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("accumulator", ["element", "row"])
def test_pack_accum_matches_jax_and_round_trips(d, accumulator):
    table, accum, ids, _ = _logical_case(d, accumulator, seed=2)
    ap = pt.pack_accum_any(torch.from_numpy(accum), d, 0.1)
    want = jpt.pack_accum_any(jnp.asarray(accum), d, 0.1)
    np.testing.assert_array_equal(ap.numpy(), np.asarray(want))
    assert tuple(ap.shape) == (pt.packed_rows(300, d),
                               128 if accumulator == "element" else pt.rows_per_tile(d))
    np.testing.assert_array_equal(pt.unpack_accum_any(ap, 300, d).numpy(),
                                  np.asarray(jpt.unpack_accum_any(want, 300, d)))
    assert torch.equal(pt.unpack_accum_any(ap, 300, d), torch.from_numpy(accum))
    # The logical rows JAX's packed gather reads are the port's.
    live = ids[ids < 300]
    np.testing.assert_array_equal(
        pt.unpack_accum_any(ap, 300, d).numpy()[live],
        np.asarray(jpt.packed_accum_gather_any(want, jnp.asarray(live), d)))


@pytest.mark.parametrize("accumulator", ["element", "row"])
def test_packed_tail_refuses_a_rows_layout_table(accumulator):
    table, accum, ids, grads = _logical_case(9, accumulator, seed=4)
    with pytest.raises(ValueError, match="a packed tail takes table"):
        rows_tail_adagrad_update(torch.from_numpy(table), torch.from_numpy(accum),
                                 torch.from_numpy(ids), torch.from_numpy(grads), 0.05,
                                 packed=True)


@pytest.mark.parametrize("accumulator", ["element", "row"])
def test_packed_state_round_trips_through_the_npz_save(tmp_path, accumulator):
    model = build_model(Config(order=3, factor_num=K, vocabulary_size=V))
    gen = torch.Generator().manual_seed(3)
    state = init_packed_state(model, gen, 0.1, accumulator)
    assert state.layout == "packed"
    assert tuple(state.table_accum.shape) == (
        (pt.packed_rows(V, 1 + K), 128) if accumulator == "element"
        else (pt.packed_rows(V, 1 + K), pt.rows_per_tile(1 + K)))
    state.table_accum.uniform_(0.1, 0.9, generator=gen)  # keep the pad slots
    logical = unpack_state(state, model)
    assert logical.layout == "rows" and logical.table.shape == (V, 1 + K)
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, logical)
    width = 1 + K if accumulator == "element" else 1
    back = pack_state(restore_checkpoint(path, CPU, accum_width=width), 0.1)
    assert torch.equal(back.table, state.table)
    # The logical rows come back; the pad lanes carry the init value.
    assert torch.equal(unpack_state(back, model).table_accum, logical.table_accum)
    fresh = init_state(model, torch.Generator().manual_seed(3), 0.1, accumulator)
    assert torch.equal(pack_state(fresh, 0.1).table, init_packed_state(
        model, torch.Generator().manual_seed(3), 0.1, accumulator).table)
    with pytest.raises(ValueError, match="scoring state"):
        unpack_state(pack_state(dataclasses.replace(fresh, table_accum=None)), model)


# --- dedup_gather_rows ----------------------------------------------------------


def _batches(n, **kw):
    stream = batch_stream([TRAIN], batch_size=B, vocabulary_size=V, max_nnz=NNZ, **kw)
    return [next(stream) for _ in range(n)]


def _rows_state(seed=0, accumulator="element"):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.uniform(-0.3, 0.3, (V, 1 + K)).astype(np.float32))
    width = 1 + K if accumulator == "element" else 1
    return TrainState(table=table, dense=[], step=0,
                      table_accum=torch.full((V, width), 0.1))


def _kw(tmp_path, name, **kw):
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
    jcfg = JaxConfig(telemetry_profile_costs=False, model="fm", order=3, factor_num=K,
                     vocabulary_size=V, adagrad_accumulator=accumulator).validate()
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, accumulator)
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table)))


def _run(tmp_path, name, **kw):
    """The port's train from the shared npz; returns (state, log)."""
    cfg = Config(**_kw(tmp_path, name, **kw)).validate()
    shutil.copy(tmp_path / "init.ckpt", cfg.model_file)
    log = []
    return train(cfg, resume=True, log=log.append, device="cpu"), log


@pytest.mark.parametrize("k", [1, 2])
def test_train_with_dedup_gather_rows_is_bitwise_the_plain_run(tmp_path, k):
    _shared_npz(tmp_path / "init.ckpt")
    plain, plain_log = _run(tmp_path, "plain.ckpt", steps_per_call=k, binary_cache=True,
                            shuffle=True)
    dedup, dedup_log = _run(tmp_path, "dedup.ckpt", steps_per_call=k, binary_cache=True,
                            shuffle=True, dedup_gather_rows=B * NNZ)
    assert dedup.step == plain.step == 40
    assert torch.equal(dedup.table, plain.table)
    assert torch.equal(dedup.table_accum, plain.table_accum)
    strip = lambda lines: [l.split(" examples/sec")[0] for l in lines if l.startswith("step ")]  # noqa: E731
    assert strip(dedup_log) == strip(plain_log)
    note = [l for l in dedup_log if l.startswith("note: dedup_gather_rows")]
    assert note == [f"note: dedup_gather_rows = {B * NNZ} names the JAX package's dedup before "
                    "the gather (the same values, fewer TPU gather bytes); the port gathers "
                    "directly and checks each batch's unique ids against the cap"]
    assert not any(l.startswith("note: dedup_gather_rows") for l in plain_log)


def test_train_refuses_a_batch_over_the_dedup_cap(tmp_path):
    _shared_npz(tmp_path / "init.ckpt")
    with pytest.raises(PrefetchError, match="dedup_gather_rows = 16 but a batch carries"):
        _run(tmp_path, "dedup.ckpt", dedup_gather_rows=16)
    for kw, needle in ((dict(table_layout="packed"), "requires table_layout = rows"),
                       (dict(device_cache=True), "STREAMED path")):
        with pytest.raises(ValueError, match=needle):
            Config(dedup_gather_rows=64, **kw).validate()


# --- train on the packed element/row layout ----------------------------------


def _losses(lines):
    return [float(s.split()[5]) for s in lines if s.startswith("step ")]


@pytest.mark.parametrize("accumulator", ["element", "row"])
@pytest.mark.parametrize("mode", [dict(), dict(binary_cache=True, shuffle=True, steps_per_call=4),
                                  dict(device_cache=True, binary_cache=True, steps_per_call=3)],
                         ids=["text", "fmb-shuffle-K4", "cached-K3"])
def test_train_on_packed_matches_jax_and_the_rows_run(tmp_path, accumulator, mode):
    _shared_npz(tmp_path / "init.ckpt", accumulator)
    kw = dict(mode, adagrad_accumulator=accumulator)
    state, log = _run(tmp_path, "port.ckpt", table_layout="packed", **kw)
    assert state.layout == "packed" and state.step == 40
    assert f"sparse tail: rows_tail_adagrad at the packed address ({accumulator} accumulator)" in log
    jcfg = JaxConfig(telemetry_profile_costs=False,
                     **_kw(tmp_path, "jax.ckpt", table_layout="packed", **kw)).validate()
    shutil.copy(tmp_path / "init.ckpt", jcfg.model_file)
    jlog = []
    jax_train(jcfg, resume=True, log=jlog.append)
    got, want = _losses(log), _losses(jlog)
    assert len(got) == len(want) >= 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    width = 1 + K if accumulator == "element" else 1
    mine = restore_checkpoint(str(tmp_path / "port.ckpt"), CPU, accum_width=width)
    with np.load(jcfg.model_file) as z:
        np.testing.assert_allclose(mine.table.numpy(), z["table"], atol=1e-5)
        np.testing.assert_allclose(mine.table_accum.numpy(), z["table_accum"], atol=1e-5)
    # Bitwise the port's rows run with the same accumulator.
    rows, _ = _run(tmp_path, "rows.ckpt", **kw)
    logical = unpack_state(state, build_model(Config(order=3, factor_num=K, vocabulary_size=V)))
    assert torch.equal(logical.table, rows.table)
    assert torch.equal(logical.table_accum, rows.table_accum)
    assert torch.equal(mine.table, rows.table)


def test_packed_step_body_refuses_a_state_without_an_accumulator():
    model = build_model(Config(order=3, factor_num=K, vocabulary_size=V))
    scoring = pack_state(dataclasses.replace(_rows_state(), table_accum=None))
    parsed, w = _batches(1)[0]
    with pytest.raises(ValueError, match="without an accumulator"):
        packed_train_step_body(model, 0.05, scoring, Batch.from_parsed(parsed, w, CPU))
    with pytest.raises(ValueError, match="got rows"):
        packed_train_step_body(model, 0.05, _rows_state(), Batch.from_parsed(parsed, w, CPU))
    assert train_step_body  # the rows body stays the rows layout's
