"""Port: the packed wire (data/wire.py), against fast_tffm_tpu/data/wire.py.

* ``pack_batch`` / ``pack_superbatch`` write the JAX packer's bytes for every
  spec: id widths 1-4, with and without vals (and so nnz), fields and
  weights, K = 1 and K = 3.  Tolerance: none.
* The port's torch unpack gives the JAX unpack's arrays bit for bit.
* Every check the packer makes instead of trusting a flag raises in both
  packages with the same message.
* The converted stream reads and converts in two threads, accounting each
  item once, and a reading failure surfaces as it was raised.
* ``fmb_wire_flags`` agrees on FMB files written by either package.
* Training on FMB input: ``wire_format = packed`` is bitwise ``arrays`` at
  K = 1 and K = 2, and matches JAX ``train`` on the same FMB file (losses
  rtol 1e-5, tables atol 1e-5, as tests/test_torch_training.py); the wire
  ships at K = 2 and K = 1 converts in the loop.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.data import binary as jax_binary
from fast_tffm_tpu.data import wire as jax_wire
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data import binary, wire
from fast_tffm_tpu_torch.data.libsvm import ParsedBatch
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
CPU = torch.device("cpu")
B, N = 6, 5
# vocabulary sizes whose ids need 1, 2, 3 and 4 bytes
VOCABS = {1: 200, 2: 60_000, 3: 1 << 20, 4: 1 << 30}


def _parsed(rng, vocab: int, ones: bool) -> ParsedBatch:
    nnz = rng.integers(0, N + 1, size=B).astype(np.int32)
    mask = np.arange(N) < nnz[:, None]
    ids = np.where(mask, rng.integers(0, vocab, size=(B, N)), 0).astype(np.int32)
    ids[0, 0] = vocab - 1  # the widest id the spec must hold
    nnz[0] = max(1, nnz[0])
    mask = np.arange(N) < nnz[:, None]
    vals = mask.astype(np.float32) if ones else np.where(
        mask, rng.uniform(-2, 2, size=(B, N)), 0).astype(np.float32)
    fields = np.where(mask, rng.integers(0, 7, size=(B, N)), 0).astype(np.int32)
    labels = rng.integers(0, 2, size=B).astype(np.float32)
    return ParsedBatch(labels=labels, ids=ids, vals=vals, fields=fields, nnz=nnz)


def _weights(rng, uniform: bool) -> np.ndarray:
    if uniform:
        return (np.arange(B) < B - 2).astype(np.float32)  # a padded tail
    return rng.uniform(0.5, 2.0, size=B).astype(np.float32)


def _case(id_bytes, vals, fields, weights, k, seed=0):
    rng = np.random.default_rng(seed + 17 * id_bytes + 3 * k)
    vocab = VOCABS[id_bytes]
    kw = dict(with_vals=vals, with_fields=fields, with_weights=weights)
    spec, jspec = wire.make_spec(vocab, N, **kw), jax_wire.make_spec(vocab, N, **kw)
    assert tuple(spec) == tuple(jspec) and spec.id_bytes == id_bytes
    seq = [_parsed(rng, vocab, ones=not vals) for _ in range(k)]
    ws = [_weights(rng, uniform=not weights) for _ in range(k)]
    return spec, jspec, seq, ws


GRID = list(itertools.product((1, 2, 3, 4), (False, True), (False, True), (False, True), (1, 3)))


@pytest.mark.parametrize("id_bytes,vals,fields,weights,k", GRID)
def test_pack_bytes_are_the_jax_packers(id_bytes, vals, fields, weights, k):
    spec, jspec, seq, ws = _case(id_bytes, vals, fields, weights, k)
    if k == 1:
        got = wire.pack_batch(spec, seq[0], ws[0])
        want = jax_wire.pack_batch(jspec, seq[0], ws[0])
    else:
        got = wire.pack_superbatch(spec, seq, ws)
        want = jax_wire.pack_superbatch(jspec, seq, ws)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert got.size == k * spec.batch_nbytes(B)


@pytest.mark.parametrize(
    "id_bytes,vals,extras,k",
    list(itertools.product((1, 2, 3, 4), (False, True), (False, True), (1, 3))),
)
def test_torch_unpack_is_the_jax_unpack_bitwise(id_bytes, vals, extras, k):
    """``extras`` ships fields and weights (else both are left out)."""
    spec, jspec, seq, ws = _case(id_bytes, vals, extras, extras, k, seed=1)
    buf = (wire.pack_batch(spec, seq[0], ws[0]) if k == 1
           else wire.pack_superbatch(spec, seq, ws))
    got = wire.make_unpacker(spec)(torch.from_numpy(buf))
    want = jax_wire.make_unpacker(jspec)(jnp.asarray(buf))
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        assert g.tobytes() == w.tobytes(), f.name
    # ... and the arrays path's batch, bit for bit.
    lead = (k,) if k > 1 else ()
    assert got.ids.shape == (*lead, B, N)
    np.testing.assert_array_equal(got.ids.reshape(-1, N).numpy(),
                                  np.concatenate([p.ids for p in seq]))
    np.testing.assert_array_equal(got.vals.reshape(-1, N).numpy(),
                                  np.concatenate([p.vals for p in seq]))
    np.testing.assert_array_equal(got.weights.reshape(-1).numpy(), np.concatenate(ws))


def _bad_labels(p, w):
    return dataclasses.replace(p, labels=p.labels + 0.5), w


def _bad_vals(p, w):
    return dataclasses.replace(p, vals=p.vals * 2.0), w


def _bad_weights(p, w):
    return p, w[::-1].copy()


def _bad_ids(p, w):
    ids = p.ids.copy()
    ids[1, 0] = 1 << 16
    return dataclasses.replace(p, ids=ids), w


def _negative_ids(p, w):
    ids = p.ids.copy()
    ids[2, 0] = -1
    return dataclasses.replace(p, ids=ids), w


@pytest.mark.parametrize("spoil,needle", [
    (_bad_labels, "labels outside"),
    (_bad_vals, "all-ones pattern"),
    (_bad_weights, "uniform 1.0-prefix"),
    (_bad_ids, "ids span"),
    (_negative_ids, r"ids span \[-1,"),
])
def test_packer_refusals_are_jaxs(spoil, needle):
    spec, jspec, seq, ws = _case(2, False, False, False, 1, seed=2)
    p, w = spoil(seq[0], ws[0])
    errors = []
    for mod, s in ((wire, spec), (jax_wire, jspec)):
        with pytest.raises(ValueError, match=needle) as e:
            mod.pack_batch(s, p, w)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_converted_stream_runs_in_two_stages():
    """The converted stream of training (``_prefetched``): one thread reads,
    a second packs, ships and unpacks; each item is accounted once, with
    its production and conversion time and its wire bytes, and a failure
    in the reading stage surfaces as that stage raised it."""
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.utils.prefetch import InputStats, PrefetchError, prefetch

    import sys

    spec, _, seq, ws = _case(3, True, False, False, 40, seed=4)

    def stream(pairs):
        stats = InputStats()
        made = prefetch(stats.produced(pairs), depth=1)
        return stats, prefetch(stats.converting(made, wire.WireConverter(spec, CPU)),
                               depth=1, stats=stats, name="input-convert")

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # many thread switches inside each item
    try:
        stats, staged = stream(zip(seq, ws))
        got = [(s.ready(), ex) for s, ex in staged]
    finally:
        sys.setswitchinterval(switch)
    assert [ex for _, ex in got] == [B] * len(seq)
    for (batch, _), p, w in zip(got, seq, ws):
        want = Batch.from_parsed(p, w)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(batch, f.name), getattr(want, f.name)), f.name
    rec = stats.drain()
    assert rec["input_items"] == rec["input_steps"] == len(seq)
    assert rec["wire_bytes_per_step"] == spec.batch_nbytes(B) and rec["h2d_ms"] >= 0

    def failing():
        yield seq[0], ws[0]
        raise OSError("the reader broke")

    _, staged = stream(failing())
    with pytest.raises(PrefetchError, match="'input-prefetch' raised OSError") as e:
        list(staged)
    assert isinstance(e.value.__cause__, OSError)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ones", [True, False])
def test_fmb_wire_flags_agree(tmp_path, writer, ones):
    src = tmp_path / "src.libsvm"
    rows = ["1 3:1 7:1", "0 5:1", "1 2:1 4:1 9:1"]
    if not ones:
        rows.append("0 8:0.5")
    src.write_text("\n".join(rows) + "\n")
    mod = jax_binary if writer == "jax" else binary
    path = mod.write_fmb(str(src), str(tmp_path / "f.fmb"), vocabulary_size=16)
    got, want = binary.fmb_wire_flags([path]), jax_binary.fmb_wire_flags([path])
    assert got == want and got[0] is ones
    assert binary.fmb_wire_flags([path, str(src)]) == (False, False)  # text in the list


def _fmb(tmp_path):
    return binary.write_fmb(TRAIN, str(tmp_path / "train.fmb"), vocabulary_size=256)


def _kw(tmp_path, name, fmb, **kw):
    base = dict(model="fm", order=3, factor_num=8, vocabulary_size=256, max_nnz=8,
                model_file=str(tmp_path / name), train_files=(fmb,), epoch_num=2,
                batch_size=20, learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4,
                log_every=5, save_every_epochs=0)
    base.update(kw)
    return base


def _shared_init(path):
    cfg = JaxConfig(model="fm", order=3, factor_num=8, vocabulary_size=256).validate()
    state = jax_init_state(jax_build_model(cfg), jax.random.key(0), 0.1, "element")
    table = np.random.default_rng(0).uniform(-0.3, 0.3, size=(256, 9)).astype(np.float32)
    jax_save_checkpoint(path, state._replace(table=jnp.asarray(table)))


def _losses(lines):
    return [float(x.split("loss ")[1].split()[0]) for x in lines if " loss " in x]


def _train(kw, resume=True):
    lines = []
    state = train(Config(**kw).validate(), resume=resume, device="cpu", log=lines.append)
    return state, lines


@pytest.mark.parametrize("k", [1, 2])
def test_packed_training_is_arrays_bitwise_and_matches_jax(tmp_path, k):
    fmb = _fmb(tmp_path)
    runs = {}
    for fmt in ("packed", "arrays"):
        kw = _kw(tmp_path, f"{fmt}.ckpt", fmb, wire_format=fmt, steps_per_call=k,
                 metrics_path=str(tmp_path / f"{fmt}.jsonl"))
        _shared_init(kw["model_file"])
        runs[fmt] = _train(kw)
    (ps, pl), (as_, al) = runs["packed"], runs["arrays"]
    assert _losses(pl) == _losses(al) and len(_losses(pl)) >= 4
    assert torch.equal(ps.table, as_.table) and torch.equal(ps.table_accum, as_.table_accum)
    import json

    def wire_bytes(fmt):
        recs = [json.loads(x) for x in open(tmp_path / f"{fmt}.jsonl")]
        return [r["wire_bytes_per_step"] for r in recs if r["kind"] == "input"]

    spec = wire.make_spec(256, 8, with_vals=True, with_fields=False, with_weights=False)
    # K = 1 converts in the loop under either setting (not measured there).
    assert set(wire_bytes("packed")) == ({spec.batch_nbytes(20)} if k > 1 else {None})
    assert set(wire_bytes("arrays")) == {None}
    jkw = _kw(tmp_path, "jax.ckpt", fmb, steps_per_call=k)
    _shared_init(jkw["model_file"])
    jlines = []
    jax_train(JaxConfig(**jkw, telemetry_profile_costs=False).validate(), resume=True,
              log=lambda *a: jlines.append(" ".join(map(str, a))))
    np.testing.assert_allclose(_losses(pl), _losses(jlines), rtol=1e-5)
    jstate = restore_checkpoint(jkw["model_file"], CPU, accum_width=9)
    np.testing.assert_allclose(ps.table.numpy(), jstate.table.numpy(), atol=1e-5)
    np.testing.assert_allclose(ps.table_accum.numpy(), jstate.table_accum.numpy(), atol=1e-5)
