"""Port: the model zoo (order-2 FM, FFM, DeepFM) against the JAX package on the CPU.

Every cross-package case starts from numpy-seeded inputs or from one npz
that the JAX package saved; tolerances, and why:

* scores and gradients at float32: rtol 1e-5, atol 1e-6 (the same float32
  products, summed in another order);
* DeepFM at bfloat16: both packages round the matmul operands to bfloat16
  and sum the exact products in float32; the gradients are rounded to
  bfloat16 at the cast, so a sum that lands on the other side of a rounding
  boundary moves one bfloat16 ulp: rtol 8e-3 (two ulps), atol 1e-6;
* a few train steps: losses rtol 1e-5, tables, accumulators and dense
  leaves atol 1e-5 (float32 drift of the summation order over the steps);
* end to end: validation AUC within 1e-4, printed scores within 1e-6.

FFM at bfloat16 has no JAX counterpart on the CPU: XLA's CPU backend runs
no batched bfloat16 dot with a float32 result, so only its float32 scores
are held against JAX (and its bfloat16 scores against its float32 ones on
rounded operands).
"""

import dataclasses
import io
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
from fast_tffm_tpu.config import load_config as jax_load_config
from fast_tffm_tpu.data import device_cache as jax_device_cache
from fast_tffm_tpu.models import Batch as JaxBatch
from fast_tffm_tpu.models import DeepFMModel as JaxDeepFM
from fast_tffm_tpu.models import FFMModel as JaxFFM
from fast_tffm_tpu.prediction import predict as jax_predict
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.trainer import make_train_step as jax_make_train_step
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model, load_config
from fast_tffm_tpu_torch.data import binary, device_cache
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.models import Batch, DeepFMModel, FFMModel
from fast_tffm_tpu_torch.models.base import compute_round
from fast_tffm_tpu_torch.models.ffm import one_hot
from fast_tffm_tpu_torch.prediction import predict
from fast_tffm_tpu_torch.serving import ServingEngine
from fast_tffm_tpu_torch.trainer import make_train_step
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
V, F, NNZ = 97, 4, 6  # vocabulary, FFM fields, FFM slots
SLOTS = 5  # DeepFM / order-2 FM slots (= num_fields)


def quiet(*_):
    pass


def _jax_cfg(**kw):
    return JaxConfig(telemetry_profile_costs=False, **kw).validate()


def _libffm(rng, n, fields=F + 2):
    """libffm lines of 2..NNZ tokens; field ids run past F (to F + 1)."""
    out = []
    for _ in range(n):
        m = int(rng.integers(2, NNZ + 1))
        toks = [f"{rng.integers(0, fields)}:{rng.integers(0, V)}:{rng.uniform(0.1, 1.5):.4f}"
                for _ in range(m)]
        out.append(f"{rng.integers(0, 2)} " + " ".join(toks))
    return out


def _libsvm(rng, n, slots=SLOTS):
    """libsvm lines of slots - 1 or slots tokens (padding in the short ones)."""
    out = []
    for _ in range(n):
        m = int(rng.integers(slots - 1, slots + 1))
        toks = [f"{i}:{rng.uniform(0.1, 1.5):.4f}" for i in rng.choice(V, m, replace=False)]
        out.append(f"{rng.integers(0, 2)} " + " ".join(toks))
    return out


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo")
    rng = np.random.default_rng(31)
    return {
        "ffm_train": _write(tmp / "tr.libffm", _libffm(rng, 160)),
        "ffm_valid": _write(tmp / "va.libffm", _libffm(rng, 60)),
        "svm_train": _write(tmp / "tr.libsvm", _libsvm(rng, 160)),
        "svm_valid": _write(tmp / "va.libsvm", _libsvm(rng, 60)),
    }


MODELS = {
    "fm2": dict(model="fm", order=2, factor_num=3, max_nnz=SLOTS, learning_rate=0.1),
    "ffm": dict(model="ffm", num_fields=F, factor_num=3, max_nnz=NNZ, learning_rate=0.1),
    "deepfm": dict(model="deepfm", num_fields=SLOTS, factor_num=3, hidden_dims=(7, 6),
                   max_nnz=SLOTS, learning_rate=0.05),
    "deepfm_bf16": dict(model="deepfm", num_fields=SLOTS, factor_num=3, hidden_dims=(7, 6),
                        max_nnz=SLOTS, learning_rate=0.05, compute_dtype="bfloat16"),
}


def _kw(files, name, tmp_path, **kw):
    spec = MODELS[name]
    ffm = spec["model"] == "ffm"
    base = dict(
        vocabulary_size=V, batch_size=16, epoch_num=1, factor_lambda=1e-4, bias_lambda=1e-4,
        log_every=4, model_file=str(tmp_path / f"{name}.ckpt"),
        score_path=str(tmp_path / f"{name}.scores"),
        train_files=(files["ffm_train" if ffm else "svm_train"],),
        validation_files=(files["ffm_valid" if ffm else "svm_valid"],),
        predict_files=(files["ffm_valid" if ffm else "svm_valid"],), **spec,
    )
    base.update(kw)
    return base


def _shared_npz(kw, seed=0):
    """A JAX state (table and dense leaves from the JAX init, the factors
    redrawn from a numpy seed with non-zero biases) saved by the JAX
    package.  Returns (the JAX config, its model, the JAX state)."""
    jcfg = _jax_cfg(**kw)
    jmodel = jax_build_model(jcfg)
    state = jax_init_state(jmodel, jax.random.key(seed), 0.1, "element")
    table = np.random.default_rng(seed).uniform(-0.2, 0.2, size=state.table.shape)
    state = state._replace(table=jnp.asarray(table.astype(np.float32)))
    jax_save_checkpoint(jcfg.model_file, state)
    return jcfg, jmodel, state


def _batch(rng, b, n, f_hi, d):
    """A numpy-seeded batch with padding slots (vals 0, field 0) and field
    ids up to f_hi - 1, and gathered rows [b, n, d]."""
    vals = rng.uniform(0.1, 1.2, size=(b, n)).astype(np.float32)
    fields = rng.integers(0, f_hi, size=(b, n)).astype(np.int32)
    vals[:, -2:], fields[:, -2:] = 0.0, 0
    arrays = dict(
        labels=rng.integers(0, 2, size=b).astype(np.float32),
        ids=rng.integers(0, V, size=(b, n)).astype(np.int32),
        vals=vals, fields=fields, weights=np.ones(b, np.float32),
    )
    rows = rng.uniform(-0.3, 0.3, size=(b, n, d)).astype(np.float32)
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            Batch(**{k: torch.from_numpy(v) for k, v in arrays.items()}), rows)


def _port_grads(model, rows, dense, batch, coef):
    r = torch.from_numpy(rows).requires_grad_(True)
    d = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in dense]
    score = model.score(r, d, batch)
    g = torch.autograd.grad(torch.sum(score * torch.from_numpy(coef)), [r, *d])
    return score.detach().numpy(), g[0].numpy(), [x.numpy() for x in g[1:]]


def test_ffm_score_and_gradient_match_jax():
    """Padding slots, and field ids F and F + 2 (zero one-hot rows)."""
    rng = np.random.default_rng(3)
    jm, pm = JaxFFM(V, F, 3), FFMModel(V, F, 3)
    jb, pb, rows = _batch(rng, 12, NNZ, F + 3, pm.row_dim)
    assert int(np.asarray(jb.fields).max()) >= F
    coef = rng.normal(size=12).astype(np.float32)
    want, jg = jax.value_and_grad(lambda r: jm.score(r, {}, jb) @ coef)(jnp.asarray(rows))
    score, g, _ = _port_grads(pm, rows, [], pb, coef)
    np.testing.assert_allclose(score, np.asarray(jm.score(jnp.asarray(rows), {}, jb)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert np.abs(g[..., 1:]).max() > 1e-2


def test_ffm_bfloat16_is_float32_on_rounded_operands():
    """bfloat16 FFM = float32 FFM over factors and values rounded to
    bfloat16, the linear term from the unrounded ones (as in the JAX model)."""
    rng = np.random.default_rng(4)
    pm16, pm32 = FFMModel(V, F, 3, compute_dtype="bfloat16"), FFMModel(V, F, 3)
    _, pb, rows = _batch(rng, 8, NNZ, F + 1, pm32.row_dim)
    r = torch.from_numpy(rows)
    rounded = torch.cat([r[..., :1], compute_round(r[..., 1:], "bfloat16")], dim=-1)
    pb16 = dataclasses.replace(pb, vals=compute_round(pb.vals, "bfloat16"))
    linear_fix = torch.sum(r[..., 0] * (pb.vals - pb16.vals), dim=-1)
    want = pm32.score(rounded, [], pb16) + linear_fix
    torch.testing.assert_close(pm16.score(r, [], pb), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepfm_score_and_gradients_match_jax(dtype):
    rng = np.random.default_rng(5)
    kw = dict(vocabulary_size=V, num_fields=SLOTS, factor_num=3, hidden_dims=(7, 6, 5),
              compute_dtype=dtype)
    jm, pm = JaxDeepFM(**kw), DeepFMModel(**kw)
    jb, pb, rows = _batch(rng, 12, SLOTS, 1, pm.row_dim)
    dense = jm.init_dense(jax.random.key(2))
    leaves = jax.tree.flatten(dense)[0]
    coef = rng.normal(size=12).astype(np.float32)
    want = np.asarray(jm.score(jnp.asarray(rows), dense, jb))
    jg_rows, jg_dense = jax.grad(lambda r, d: jm.score(r, d, jb) @ coef, argnums=(0, 1))(
        jnp.asarray(rows), dense)
    score, g_rows, g_dense = _port_grads(pm, rows, leaves, pb, coef)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=1e-6)
    np.testing.assert_allclose(score, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_rows, np.asarray(jg_rows), **tol)
    for got, ref in zip(g_dense, jax.tree.flatten(jg_dense)[0], strict=True):
        np.testing.assert_allclose(got, np.asarray(ref), **tol)
    if dtype == "bfloat16":  # the weights' gradient is rounded at the cast, as JAX's
        for name, got in zip(pm.dense_names, g_dense):
            rounded = np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
            assert rounded == name.startswith("w"), name


def test_deepfm_dense_leaves_are_in_jax_tree_flatten_order():
    kw = dict(vocabulary_size=V, num_fields=SLOTS, factor_num=3, hidden_dims=(7, 6, 5))
    jdense = JaxDeepFM(**kw).init_dense(jax.random.key(0))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jdense)[0]]
    pm = DeepFMModel(**kw)
    assert [f"['{n}']" for n in pm.dense_names] == paths
    assert pm.dense_names == ["b0", "b1", "b2", "b3", "w0", "w1", "w2", "w3"]
    got = pm.init_dense(torch.Generator().manual_seed(0))
    want = jax.tree.flatten(jdense)[0]
    assert [tuple(p.shape) for p in got] == [tuple(w.shape) for w in want]
    for name, p in zip(pm.dense_names, got):  # He-initialised weights, zero biases
        assert (float(p.abs().max()) == 0.0) == name.startswith("b")


def test_one_hot_gives_zero_rows_out_of_range():
    fields = np.array([[0, 3, 4, 7, -1], [2, 1, 0, 5, 3]], np.int32)
    got = one_hot(torch.from_numpy(fields), 4)
    assert np.array_equal(got.numpy(), np.asarray(jax.nn.one_hot(jnp.asarray(fields), 4)))
    assert float(got[0, 2:].abs().sum()) == 0.0


@pytest.mark.parametrize("name", list(MODELS))
def test_train_steps_match_jax(tmp_path, files, name):
    """Six make_train_step steps from one JAX-saved npz: the same losses,
    table, accumulators and (DeepFM) dense leaves and their accumulators."""
    kw = _kw(files, name, tmp_path)
    jcfg, jmodel, jstate = _shared_npz(kw)
    cfg = Config(**kw).validate()
    model = build_model(cfg)
    state = restore_checkpoint(cfg.model_file, CPU, n_dense=len(model.dense_names),
                               accum_width=model.row_dim)
    assert len(state.dense) == len(jax.tree.flatten(jstate.dense)[0])
    jstep, step = jax_make_train_step(jmodel, cfg.learning_rate), make_train_step(
        model, cfg.learning_rate)
    stream = batch_stream(cfg.train_files, batch_size=16, vocabulary_size=V, max_nnz=cfg.max_nnz)
    for _ in range(6):
        parsed, w = next(stream)
        jstate, jloss = jstep(jstate, JaxBatch.from_parsed(parsed, w,
                                                           with_fields=jmodel.uses_fields))
        state, loss = step(state, Batch.from_parsed(parsed, w, with_fields=model.uses_fields))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(state.table.numpy(), np.asarray(jstate.table), atol=1e-5)
    np.testing.assert_allclose(state.table_accum.numpy(), np.asarray(jstate.table_opt.accum),
                               atol=1e-5)
    jd = jax.tree.flatten(jstate.dense)[0]
    ja = jax.tree.flatten(jstate.dense_opt.accum)[0]
    for got, want in zip(state.dense + state.dense_accum, jd + ja, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert state.step == int(jstate.step) == 6


def test_deepfm_npz_restores_in_both_packages(tmp_path, files):
    kw = _kw(files, "deepfm", tmp_path)
    jcfg, jmodel, jstate = _shared_npz(kw, seed=3)
    model = build_model(Config(**kw).validate())
    assert model.dense_names == ["b0", "b1", "b2", "w0", "w1", "w2"]
    state = restore_checkpoint(jcfg.model_file, CPU, n_dense=6, accum_width=model.row_dim)
    jd = jax.tree.flatten(jstate.dense)[0]
    for got, want in zip(state.dense, jd, strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # The port's save, with moved leaves and accumulators, in the JAX package.
    state.dense = [p + i for i, p in enumerate(state.dense)]
    state.dense_accum = [a * (i + 2) for i, a in enumerate(state.dense_accum)]
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, state, chunk_bytes=64)
    back = jax_restore_checkpoint(path, jstate)
    for got, want in zip(jax.tree.flatten(back.dense)[0], state.dense, strict=True):
        assert np.array_equal(np.asarray(got), want.numpy())
    for got, want in zip(jax.tree.flatten(back.dense_opt.accum)[0], state.dense_accum):
        assert np.array_equal(np.asarray(got), want.numpy())
    with np.load(path) as z:
        assert {f"dense_{i}" for i in range(6)} <= set(z.files)
        assert z["dense_0"].shape == (7,) and z["dense_3"].shape == (SLOTS * 3, 7)


@pytest.mark.parametrize("cfg_name", ["baseline1_fm_criteo_sample.cfg",
                                      "baseline3_ffm_avazu.cfg",
                                      "baseline4_deepfm_criteo.cfg"])
def test_load_config_builds_the_jax_model(cfg_name):
    path = os.path.join(REPO, "configs", cfg_name)
    got, want = build_model(load_config(path)), jax_build_model(jax_load_config(path))
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.row_dim, got.uses_fields) == (want.row_dim, want.uses_fields)
    assert got.row_dim == {"baseline1_fm_criteo_sample.cfg": 9, "baseline3_ffm_avazu.cfg": 89,
                           "baseline4_deepfm_criteo.cfg": 9}[cfg_name]


def test_fields_reach_the_batch_on_every_input_path(tmp_path, files):
    """from_parsed, stack_parsed, the FMB stream and the device cache carry
    the [.., N] field matrix with_fields, as the JAX package's do."""
    src = files["ffm_train"]
    kw = dict(batch_size=16, vocabulary_size=V, max_nnz=NNZ)
    text = list(batch_stream([src], **kw))
    assert np.asarray(text[0][0].fields).max() >= F
    one = Batch.from_parsed(*text[0], with_fields=True)
    want = JaxBatch.from_parsed(*text[0], with_fields=True)
    assert np.array_equal(one.fields.numpy(), np.asarray(want.fields))
    assert one.fields.dtype == torch.int32
    stacked = Batch.stack_parsed([p for p, _ in text[:3]], [w for _, w in text[:3]],
                                 with_fields=True)
    jstacked = JaxBatch.stack_parsed([p for p, _ in text[:3]], [w for _, w in text[:3]])
    assert np.array_equal(stacked.fields.numpy(), np.asarray(jstacked.fields))
    fmb = binary.write_fmb(src, str(tmp_path / "tr.fmb"), vocabulary_size=V)
    for (p, _), (q, _) in zip(batch_stream([fmb], **kw), text, strict=True):
        assert np.array_equal(p.fields, q.fields)
    data = device_cache.load_device_dataset([fmb], with_fields=True, **kw)
    jdata = jax_device_cache.load_device_dataset([fmb], with_fields=True, **kw)
    assert data.fields.shape == (data.batches * 16, NNZ)
    assert np.array_equal(data.fields.numpy(), np.asarray(jdata.fields))
    assert data.nbytes == jdata.nbytes
    b = device_cache._batch(data, torch.tensor(2), shuffled=False)
    assert np.array_equal(b.fields.numpy(), text[2][0].fields)


def test_deepfm_refuses_a_width_other_than_num_fields(tmp_path, files):
    with pytest.raises(ValueError, match="max_nnz = num_fields"):
        Config(model="deepfm", num_fields=SLOTS, max_nnz=SLOTS + 1).validate()
    model = DeepFMModel(V, SLOTS, 3, hidden_dims=(4,))
    _, pb, rows = _batch(np.random.default_rng(1), 4, SLOTS + 2, 1, model.row_dim)
    dense = model.init_dense(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="max_nnz = num_fields"):
        model.score(torch.from_numpy(rows), dense, pb)
    # max_nnz = 0 infers the files' width (SLOTS): refused before any write.
    cfg = Config(**_kw(files, "deepfm", tmp_path, num_fields=SLOTS + 1, max_nnz=0)).validate()
    with pytest.raises(ValueError, match="max_nnz = num_fields"):
        train(cfg, device="cpu", log=quiet)
    assert not os.path.exists(cfg.model_file)


def _aucs(lines):
    return [float(s.split()[-1]) for s in lines if "validation auc" in s]


@pytest.mark.parametrize("name", ["fm2", "ffm", "deepfm"])
def test_train_resume_predict_and_serve_match_jax(tmp_path, files, name):
    """train --resume from one JAX-saved npz in each package (DeepFM's MLP
    restored and trained), then predict, and the port's serving engine."""
    kw = _kw(files, name, tmp_path, epoch_num=2, model_file=str(tmp_path / "jax.ckpt"))
    jcfg, jmodel, _ = _shared_npz(kw, seed=7)
    cfg = Config(**dict(kw, model_file=str(tmp_path / "port.ckpt"))).validate()
    shutil.copy(jcfg.model_file, cfg.model_file)
    jlog, log = [], []
    jax_train(jcfg, resume=True, log=jlog.append)
    state = train(cfg, resume=True, log=log.append, device="cpu")
    assert state.step == 20 and len(state.dense) == (6 if name == "deepfm" else 0)
    np.testing.assert_allclose(_aucs(log), _aucs(jlog), atol=1e-4)
    assert len(_aucs(log)) == 2
    jstate = jax_restore_checkpoint(jcfg.model_file, jax_init_state(jmodel, jax.random.key(0)))
    np.testing.assert_allclose(state.table.numpy(), np.asarray(jstate.table), atol=1e-5)
    for got, want in zip(state.dense, jax.tree.flatten(jstate.dense)[0], strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    jax_predict(jcfg, log=quiet)
    predict(cfg, log=quiet, device="cpu")
    want, got = np.loadtxt(jcfg.score_path), np.loadtxt(cfg.score_path)
    assert got.shape == want.shape == (60,)
    np.testing.assert_allclose(got, want, atol=1e-5 + 1e-9)

    lines = open(cfg.predict_files[0]).read().splitlines()
    with ServingEngine(cfg, log=quiet, device="cpu") as engine:
        served = np.array([engine.submit_line(s).result() for s in lines])
    np.testing.assert_allclose(served, got, atol=1e-6 + 1e-9)


def test_serve_lines_scores_libffm_with_fields(tmp_path, files):
    """An FFM engine fills the bucket's fields from parsed libffm lines: the
    served scores are the model's on batches built with their fields, and
    differ from what the same rows score with every field 0."""
    from fast_tffm_tpu_torch.serving import serve_lines

    kw = _kw(files, "ffm", tmp_path)
    _shared_npz(kw, seed=9)
    cfg = Config(**kw).validate()
    lines = open(files["ffm_valid"]).read().splitlines()[:40]
    out = io.StringIO()
    serve_lines(cfg, lines, out=out, log=quiet, device="cpu")
    served = np.array(out.getvalue().split(), np.float64)
    model = build_model(cfg)
    state = restore_checkpoint(cfg.model_file, CPU)
    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    parsed = parse_lines(lines, vocabulary_size=V, max_nnz=NNZ)
    batch = Batch.from_parsed(parsed, with_fields=True)
    want = torch.sigmoid(model.score(state.table[batch.ids.long()], [], batch)).numpy()
    np.testing.assert_allclose(served, want, atol=1e-6 + 1e-9)
    blind = dataclasses.replace(batch, fields=torch.zeros_like(batch.fields))
    assert np.abs(torch.sigmoid(model.score(state.table[batch.ids.long()], [], blind)).numpy()
                  - want).max() > 1e-4


@pytest.mark.parametrize("name", ["ffm", "deepfm"])
def test_k_step_and_cached_steps_are_the_eager_steps(tmp_path, files, name):
    """steps_per_call on a [K, B, N] superbatch (fields included) and the
    device-cached steps over an FMB epoch: bitwise the eager steps."""
    from fast_tffm_tpu_torch.trainer import make_scanned_train_step

    kw = _kw(files, name, tmp_path)
    _shared_npz(kw, seed=4)
    cfg = Config(**kw).validate()
    model = build_model(cfg)

    def restored():
        return restore_checkpoint(cfg.model_file, CPU, n_dense=len(model.dense_names),
                                  accum_width=model.row_dim)

    fmb = binary.write_fmb(cfg.train_files[0], str(tmp_path / "t.fmb"), vocabulary_size=V,
                           max_nnz=cfg.max_nnz)
    stream = list(batch_stream([fmb], batch_size=16, vocabulary_size=V, max_nnz=cfg.max_nnz))[:6]
    eager, step, want = restored(), make_train_step(model, cfg.learning_rate), []
    for parsed, w in stream:
        eager, loss = step(eager, Batch.from_parsed(parsed, w, with_fields=model.uses_fields))
        want.append(loss)
    scanned, k_step, got = restored(), make_scanned_train_step(model, cfg.learning_rate), []
    for lo in (0, 3):
        group = stream[lo:lo + 3]
        sb = Batch.stack_parsed([p for p, _ in group], [w for _, w in group],
                                with_fields=model.uses_fields)
        assert sb.fields.shape == ((3, 16, NNZ) if name == "ffm" else (3, 16, 0))
        scanned, losses = k_step(scanned, sb)
        got.append(losses)
    data = device_cache.load_device_dataset([fmb], batch_size=16, vocabulary_size=V,
                                            max_nnz=cfg.max_nnz, with_fields=model.uses_fields)
    cached, c_step = restored(), device_cache.make_cached_train_step(
        model, cfg.learning_rate, data)[0]
    c_got = []
    for i in range(6):
        cached, loss = c_step(cached, torch.tensor(i))
        c_got.append(loss)
    assert torch.equal(torch.cat(got), torch.stack(want))
    assert torch.equal(torch.stack(c_got), torch.stack(want))
    for st in (scanned, cached):
        assert torch.equal(st.table, eager.table) and st.step == eager.step == 6
        for a, b in zip(st.dense + st.dense_accum, eager.dense + eager.dense_accum, strict=True):
            assert torch.equal(a, b)
