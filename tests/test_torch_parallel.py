"""Port: ``dist_train`` / ``dist_predict`` over the mesh of ranks against the
JAX package's mesh runs, on the CPU.

The JAX runs are ``dist_train(cfg, mesh=make_mesh(d, r))`` in this process
on the emulated CPU devices (tests/conftest.py); the port's are d·r spawned
processes, each one rank of a ``gloo`` group initialized over a
``file://`` store in ``tmp_path`` (the library takes a group that is
already up), running ``dist_train(cfg, device="cpu")``.  Every pair starts
from one npz written by the JAX package.  A spawn runs several
configurations in turn, and each has a deadline: a hung rank fails the
test.

* Meshes (4, 1), (1, 4) and (2, 2), FM on the rows layout over an epoch
  with a short tail (390 rows, batches of 20: 10 real rows in the last
  one, two ranks all padding): per-step losses, tables and accumulators
  and validation AUCs within the tolerances below (tighter than rtol 1e-5
  on losses and rtol 1e-4 / atol 1e-6 on tables), the padded vocabulary's
  shape.  The three port meshes
  end bitwise equal to one another: the row split moves no arithmetic.
* The first step at (2, 2) within the port's single-device difference from
  JAX (its ``train`` against JAX ``train``, one step: the scorer's float32
  sums differ by an ulp between XLA and torch, so neither is bitwise).
* At (2, 2): packed, fused and packed row-accumulator layouts, lookup =
  alltoall with and without an overflow under ``fallback`` (the counts of
  fallen-back steps equal), an overflow under ``abort`` (the loss goes NaN
  and both packages stop before the checkpoint), steps_per_call = 4, FFM
  and DeepFM; a SIGTERM at step 8 and ``--resume``, bitwise the port's
  uninterrupted run; ``dist_predict``'s scores within 1e-6 of JAX's.
* At world size 1 (no process group) ``dist_train`` is bitwise ``train``
  on each layout, K = 4 and alltoall, and ``dist_predict`` is ``predict``.
* Module by module: the padded dedup, the capacity, the bucketizing, the
  shard apply (its CPU twin against the JAX ``apply_shard_adagrad``) and
  the sharded input streams (text, native, FMB, shuffled FMB) against the
  JAX package's.
"""

import glob
import json
import multiprocessing as mp
import os
import pickle
import shutil
import signal
import traceback
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.data.pipeline import batch_stream as jax_batch_stream
from fast_tffm_tpu.optim import dedup_rows as jax_dedup_rows
from fast_tffm_tpu.parallel import make_mesh as jax_make_mesh
from fast_tffm_tpu.parallel.alltoall import _bucketize as jax_bucketize
from fast_tffm_tpu.parallel.alltoall import capacity_for as jax_capacity_for
from fast_tffm_tpu.parallel.embedding import apply_shard_adagrad as jax_apply_shard_adagrad
from fast_tffm_tpu.prediction import dist_predict as jax_dist_predict
from fast_tffm_tpu.resilience import NonFiniteLossError as JaxNonFiniteLossError
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu.training import dist_train as jax_dist_train
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache
from fast_tffm_tpu_torch.data.native import best_parser
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.parallel.alltoall import _bucketize, capacity_for
from fast_tffm_tpu_torch.parallel.embedding import apply_shard_adagrad, dedup_rows_padded
from fast_tffm_tpu_torch.prediction import dist_predict, predict
from fast_tffm_tpu_torch.resilience import NonFiniteLossError
from fast_tffm_tpu_torch.training import dist_train, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ = 256, 8, 8  # the sample files' ids are < 200, rows <= 8 wide
F, SLOTS = 4, 5  # FFM fields; DeepFM slots (= num_fields)
SPAWN_TIMEOUT_S = 150
# Port against JAX after a 20-step run, on every configuration below: the
# tightest tolerances that hold.  Seen on this data: tables, accumulators and
# DeepFM's dense leaves at most 2.98e-8 apart (a few float32 ulp: the
# scorer's sums differ by an ulp between XLA and torch on one device
# already), the losses of the kind=train records (rounded to 6 places) at
# most 1.4e-6 apart relative, the 5-decimal AUCs equal.  The bounds asked
# of the port are looser: tables rtol 1e-4 / atol 1e-6, losses rtol 1e-5.
TABLE_RTOL, TABLE_ATOL, LOSS_RTOL, AUC_ATOL = 0.0, 1e-7, 2e-6, 2e-5


def quiet(*_):
    pass


# -- spawned ranks -----------------------------------------------------------


def _rank_entry(rank, world, store, job, args, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        payload = ("ok", job(rank, *args))
    except BaseException:  # the parent reads the traceback
        payload = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(payload, f)
    dist.destroy_process_group()


def _spawn(tmp_path, world, job, *args):
    """``job(rank, *args)`` in ``world`` spawned ranks of one gloo group;
    returns the ranks' results in rank order."""
    ctx = mp.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    store = str(tmp_path / f"store-{tag}")
    outs = [str(tmp_path / f"rank-{tag}-{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_entry, args=(r, world, store, job, args, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(SPAWN_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} rank(s) hung past {SPAWN_TIMEOUT_S} s"
    results = []
    for r, out in enumerate(outs):
        assert os.path.exists(out), f"rank {r} exited {procs[r].exitcode} with no result"
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", f"rank {r} failed:\n{value}"
        results.append(value)
    return results


class _Abort(Exception):
    """Ends a run from its step hook, before its final save."""


def _train_job(rank, runs):
    """Each run: ``(kwargs, resume, stop_at[, abort_at])``; returns per run
    its log (rank 0), the non-finite step it stopped at, or the step an
    ``abort_at`` hook ended it at (every rank: the writer's in-flight
    publish joined, no final save)."""
    out = []
    for kw, resume, stop_at, *abort_at in runs:
        logs = []
        hook = None
        if stop_at:
            def hook(step, at=stop_at, fired=[]):  # noqa: B006 — one list per run
                if step >= at and not fired:
                    fired.append(step)
                    os.kill(os.getpid(), signal.SIGTERM)
        elif abort_at:
            def hook(step, at=abort_at[0]):
                if step >= at:
                    raise _Abort(step)
        try:
            dist_train(Config(**kw).validate(), resume=resume, device="cpu", log=logs.append,
                       step_hook=hook)
            out.append({"log": logs if rank == 0 else None})
        except NonFiniteLossError as e:
            out.append({"nonfinite": e.step})
        except _Abort as e:
            out.append({"aborted": e.args[0]})
    return out


def _predict_job(rank, kw):
    dist_predict(Config(**kw).validate(), log=quiet, device="cpu")


# -- configurations ----------------------------------------------------------


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(12)
    train_lines = open(TRAIN).read().splitlines()
    ffm = [f"{rng.integers(0, 2)} " + " ".join(
        f"{rng.integers(0, F + 1)}:{rng.integers(0, V)}:{rng.uniform(0.1, 1.5):.4f}"
        for _ in range(int(rng.integers(2, NNZ + 1)))) for _ in range(200)]
    svm = [f"{rng.integers(0, 2)} " + " ".join(
        f"{i}:{rng.uniform(0.1, 1.5):.4f}" for i in rng.choice(V, SLOTS, replace=False))
        for _ in range(200)]
    return {
        "train": _write(tmp / "tail.libsvm", train_lines[:390]),
        "first": _write(tmp / "first.libsvm", train_lines[:20]),
        "valid": _write(tmp / "valid.libsvm", open(TEST).read().splitlines()[:110]),
        "ffm_train": _write(tmp / "tr.libffm", ffm[:160]),
        "ffm_valid": _write(tmp / "va.libffm", ffm[160:]),
        "svm_train": _write(tmp / "tr.libsvm", svm[:160]),
        "svm_valid": _write(tmp / "va.libsvm", svm[160:]),
    }


def _kw(tmp_path, data, name, **over):
    base = dict(
        model="fm", order=2, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / f"{name}.ckpt"), train_files=(data["train"],),
        validation_files=(data["valid"],), predict_files=(data["valid"],),
        score_path=str(tmp_path / f"{name}.scores"), epoch_num=1, batch_size=20,
        learning_rate=0.05, factor_lambda=1e-4, bias_lambda=1e-4, log_every=1,
        metrics_path=str(tmp_path / f"{name}.jsonl"), telemetry_profile_costs=False,
    )
    if over.get("model") == "ffm":
        base.update(num_fields=F, factor_num=3, train_files=(data["ffm_train"],),
                    validation_files=(data["ffm_valid"],), predict_files=(data["ffm_valid"],),
                    batch_size=16)
    if over.get("model") == "deepfm":
        base.update(num_fields=SLOTS, factor_num=3, hidden_dims=(7, 6), max_nnz=SLOTS,
                    train_files=(data["svm_train"],), validation_files=(data["svm_valid"],),
                    predict_files=(data["svm_valid"],), batch_size=16)
    base.update(over)
    return base


def _init_npz(path, kw):
    """The JAX init state of ``kw``'s model with its table redrawn from a
    numpy seed, saved by the JAX package at ``path``."""
    acc = kw.get("adagrad_accumulator", "element")
    jcfg = JaxConfig(**{**kw, "model_file": path}).validate()
    model = jax_build_model(jcfg)
    state = jax_init_state(model, jax.random.key(0), 0.1, "row" if acc == "fused" else acc)
    table = np.random.default_rng(0).uniform(-0.3, 0.3, (V, model.row_dim)).astype(np.float32)
    jax_save_checkpoint(path, state._replace(table=jnp.asarray(table)))


def _pair(tmp_path, data, name, mesh, **over):
    """(JAX kwargs, port kwargs) of one configuration on ``mesh``, each with
    its own copy of one init npz."""
    jk = _kw(tmp_path, data, f"{name}.jax", **over)
    pk = _kw(tmp_path, data, f"{name}.port", data_parallel=mesh[0], row_parallel=mesh[1],
             **over)
    _init_npz(jk["model_file"], jk)
    shutil.copy(jk["model_file"], pk["model_file"])
    return jk, pk


def _jax_run(jk, mesh, **kw):
    logs = []
    jax_dist_train(JaxConfig(**jk).validate(), resume=True, mesh=jax_make_mesh(*mesh),
                   log=lambda *a: logs.append(" ".join(map(str, a))), **kw)
    return logs


def _losses(path):
    with open(path) as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


def _aucs(log):
    return [float(line.split()[-1]) for line in log if "validation auc" in line]


def _saved(path):
    with np.load(path) as z:
        return {k: np.asarray(z[k]) for k in ("table", "table_accum", "step")} | {
            k: np.asarray(z[k]) for k in z.files if k.startswith("dense")}


def _check_pair(jk, pk, jlog, plog):
    j, p = _saved(jk["model_file"]), _saved(pk["model_file"])
    assert j["table"].shape == p["table"].shape  # the same padded vocabulary
    assert int(j["step"]) == int(p["step"])
    for key in j:
        if key != "step":
            np.testing.assert_allclose(p[key][:V], j[key][:V], rtol=TABLE_RTOL,
                                       atol=TABLE_ATOL, err_msg=key)
    jl, pl = _losses(jk["metrics_path"]), _losses(pk["metrics_path"])
    assert len(pl) == len(jl) > 0
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(_aucs(plog), _aucs(jlog), atol=AUC_ATOL)
    return p


# -- the mesh shapes ---------------------------------------------------------

MESHES = [(4, 1), (1, 4), (2, 2)]


def test_fm_rows_on_every_mesh_shape_matches_jax(tmp_path, data):
    pairs = {m: _pair(tmp_path, data, f"fm{m[0]}{m[1]}", m) for m in MESHES}
    jlogs = {m: _jax_run(jk, m) for m, (jk, _) in pairs.items()}
    plogs = [r["log"] for r in _spawn(tmp_path, 4, _train_job,
                                      [(pk, True, None) for _, pk in pairs.values()])[0]]
    saved = {}
    for (m, (jk, pk)), plog in zip(pairs.items(), plogs):
        assert f"mesh: {{'data': {m[0]}, 'row': {m[1]}}} on 4 devices" in plog
        # 390 rows: 20 steps, the last with 10 real rows.
        assert any("390 rows over 4 processes, 20 steps/epoch" in line for line in plog)
        saved[m] = _check_pair(jk, pk, jlogs[m], plog)
    for m in MESHES[1:]:
        for key in ("table", "table_accum"):
            assert np.array_equal(saved[m][key], saved[MESHES[0]][key]), (m, key)


def test_first_step_within_the_single_device_difference(tmp_path, data):
    one = dict(train_files=(data["first"],), validation_files=())
    jk, pk = _pair(tmp_path, data, "first", (2, 2), **one)
    _jax_run(jk, (2, 2))
    _spawn(tmp_path, 4, _train_job, [(pk, True, None)])
    # The single-device pair from the same npz.
    jt = _kw(tmp_path, data, "first1.jax", **one)
    pt = _kw(tmp_path, data, "first1.port", **one)
    _init_npz(jt["model_file"], jt)
    shutil.copy(jt["model_file"], pt["model_file"])
    from fast_tffm_tpu.training import train as jax_train

    jax_train(JaxConfig(**jt).validate(), resume=True, log=quiet)
    train(Config(**pt).validate(), resume=True, device="cpu", log=quiet)
    for key in ("table", "table_accum"):
        mesh_diff = np.abs(_saved(pk["model_file"])[key] - _saved(jk["model_file"])[key]).max()
        single = np.abs(_saved(pt["model_file"])[key] - _saved(jt["model_file"])[key]).max()
        assert mesh_diff <= single <= 3e-8, (key, mesh_diff, single)


CASES = {
    "packed": dict(table_layout="packed"),
    "fused": dict(table_layout="packed", adagrad_accumulator="fused"),
    "packed_row": dict(table_layout="packed", adagrad_accumulator="row"),
    "alltoall": dict(lookup="alltoall"),
    "alltoall_fallback": dict(lookup="alltoall", lookup_capacity_factor=0.01),
    "k4": dict(steps_per_call=4, log_every=4),
    "ffm": dict(model="ffm"),
    "deepfm": dict(model="deepfm"),
}


def test_layouts_lookups_models_and_k4_at_2x2_match_jax(tmp_path, data):
    mesh = (2, 2)
    pairs = {name: _pair(tmp_path, data, name, mesh, **kw) for name, kw in CASES.items()}
    abort = _pair(tmp_path, data, "abort", mesh, lookup="alltoall",
                  lookup_capacity_factor=0.01, lookup_overflow="abort")
    jlogs = {name: _jax_run(jk, mesh) for name, (jk, _) in pairs.items()}
    with pytest.raises(JaxNonFiniteLossError) as jax_abort:
        _jax_run(abort[0], mesh)
    runs = [(pk, True, None) for _, pk in pairs.values()] + [(abort[1], True, None)]
    out = _spawn(tmp_path, 4, _train_job, runs)
    for (name, (jk, pk)), res in zip(pairs.items(), out[0]):
        _check_pair(jk, pk, jlogs[name], res["log"])
    # The fallen-back steps, counted in the kind=train records of each.
    steps = [[r.get("lookup_overflow_steps", 0) for r in map(json.loads, open(kw["metrics_path"]))
              if r["kind"] == "train"] for kw in pairs["alltoall_fallback"]]
    assert steps[1] == steps[0] and sum(steps[0]) > 0, steps
    # abort: every rank stops at JAX's step, before any save.
    assert {r[-1]["nonfinite"] for r in out} == {jax_abort.value.step}
    assert int(_saved(abort[1]["model_file"])["step"]) == 0


def test_sigterm_stop_resumes_bitwise_and_dist_predict_matches_jax(tmp_path, data):
    mesh = (2, 2)
    jk, whole = _pair(tmp_path, data, "whole", mesh)
    cut = dict(whole, model_file=str(tmp_path / "cut.ckpt"), metrics_path="")
    shutil.copy(whole["model_file"], cut["model_file"])
    _spawn(tmp_path, 4, _train_job, [(whole, True, None), (cut, True, 8)])
    with np.load(cut["model_file"]) as z:
        assert int(z["step"]) == 8
        cursor = json.loads(bytes(z["input_cursor"]).decode())
    assert cursor["process_count"] == 4 and cursor["batch_in_epoch"] == 8
    assert [h["batch_in_epoch"] for h in cursor["hosts"]] == [8, 8, 8, 8]
    out = _spawn(tmp_path, 4, _train_job, [(cut, True, None)])
    assert any("resuming input at epoch 0, batch 8" in line for line in out[0][0]["log"])
    a, b = _saved(whole["model_file"]), _saved(cut["model_file"])
    for key in ("table", "table_accum", "step"):
        assert np.array_equal(a[key], b[key]), key
    # dist_predict of the trained model, JAX's and the port's.
    jp = dict(jk, model_file=whole["model_file"], score_path=str(tmp_path / "j.scores"))
    jax_dist_predict(JaxConfig(**jp).validate(), log=quiet, mesh=jax_make_mesh(*mesh))
    _spawn(tmp_path, 4, _predict_job, whole)
    got, want = np.loadtxt(whole["score_path"]), np.loadtxt(jp["score_path"])
    assert got.shape == want.shape == (110,)
    np.testing.assert_allclose(got, want, atol=1e-6)


# -- world size 1: dist_train is train ---------------------------------------


@pytest.mark.parametrize("over", [{}, CASES["packed"], CASES["fused"], CASES["k4"],
                                  CASES["alltoall"]], ids=["rows", "packed", "fused", "k4",
                                                           "alltoall"])
def test_world_size_one_is_train_bitwise(tmp_path, data, over):
    a = _kw(tmp_path, data, "t", **over)
    b = _kw(tmp_path, data, "d", **over)
    _init_npz(a["model_file"], a)
    shutil.copy(a["model_file"], b["model_file"])
    st_a = train(Config(**a).validate(), resume=True, device="cpu", log=quiet)
    st_b = dist_train(Config(**b).validate(), resume=True, device="cpu", log=quiet)
    assert st_a.layout == st_b.layout and st_a.step == st_b.step
    assert _losses(a["metrics_path"]) == _losses(b["metrics_path"])
    x, y = _saved(a["model_file"]), _saved(b["model_file"])
    for key in ("table", "table_accum"):
        assert np.array_equal(x[key], y[key][: x[key].shape[0]]), key
    predict(Config(**a).validate(), log=quiet, device="cpu")
    dist_predict(Config(**dict(b, model_file=a["model_file"])).validate(), log=quiet,
                 device="cpu")
    assert open(a["score_path"]).read() == open(b["score_path"]).read()


# -- module parity -------------------------------------------------------------


def test_padded_dedup_is_jax_dedup_rows():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, 300).astype(np.int32)
    g = rng.standard_normal((300, 5)).astype(np.float32)
    ju, jg = jax_dedup_rows(jnp.asarray(ids), jnp.asarray(g), 64)
    pu, pg = dedup_rows_padded(torch.from_numpy(ids), torch.from_numpy(g), 64)
    assert np.array_equal(pu.numpy(), np.asarray(ju))
    assert np.array_equal(pg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("m,r,f", [(40, 2, 0.01), (40, 4, 2.0), (180224, 4, 2.0), (7, 1, 2.0)])
def test_capacity_and_bucketize_are_jax(m, r, f):
    assert capacity_for(m, r, f) == jax_capacity_for(m, r, f)
    rng = np.random.default_rng(m)
    owner = rng.integers(0, r + 1, m).astype(np.int32)  # r: the sentinel owner
    cap = capacity_for(m, r, f)
    got = _bucketize(torch.from_numpy(owner), r, cap)
    want = jax_bucketize(jnp.asarray(owner), r, cap)
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("accum_width", [9, 1])
def test_shard_apply_twin_against_jax(accum_width):
    rng = np.random.default_rng(5)
    table = rng.uniform(-0.3, 0.3, (64, 9)).astype(np.float32)
    accum = np.full((64, accum_width), 0.1, np.float32)
    guids = rng.integers(0, 80, 200).astype(np.int32)  # ids past the table: other shards
    ggsum = rng.standard_normal((200, 9)).astype(np.float32)
    # JAX's apply takes deduped ids; the port's folds the dedup into B4's twin.
    ju, jg = jax_dedup_rows(jnp.asarray(guids), jnp.asarray(ggsum), 128)
    jt, ja = jax_apply_shard_adagrad(jnp.asarray(table), jnp.asarray(accum), ju, jg, 0.05, 32)
    pt, pa = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    apply_shard_adagrad(pt, pa, torch.from_numpy(guids), torch.from_numpy(ggsum), 0.05, 32)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=1e-6)


@pytest.mark.parametrize("route", ["python", "native", "fmb", "fmb_shuffled"])
def test_sharded_streams_are_jax(tmp_path, route):
    src = str(tmp_path / "t.libsvm")
    shutil.copy(TRAIN, src)
    files = [src]
    kw = dict(batch_size=7, vocabulary_size=V, max_nnz=NNZ, epochs=1)
    if route.startswith("fmb"):
        files = list(ensure_fmb_cache(files, vocabulary_size=V, max_nnz=NNZ, log=quiet))
    if route == "fmb_shuffled":
        kw["shuffle_seed"] = 11
    parser = best_parser(1) if route == "native" else None
    total = 400
    for shard in range(3):
        sk = dict(shard_index=shard, shard_count=3, shard_block=7,
                  pad_to_batches=-(-total // 21))
        got = list(batch_stream(files, parser=parser, **kw, **sk))
        want = list(jax_batch_stream(files, **kw, **sk))
        assert len(got) == len(want) == 20
        for (gp, gw), (wp, ww) in zip(got, want):
            assert np.array_equal(gw, ww)
            for f in ("labels", "ids", "vals", "nnz"):
                assert np.array_equal(getattr(gp, f), getattr(wp, f)), f


# -- device_cache under dist_train ---------------------------------------------

CACHED = {
    "rows": {},
    "k4": dict(steps_per_call=4, log_every=4),
    "packed": dict(table_layout="packed"),
    "fused": dict(table_layout="packed", adagrad_accumulator="fused"),
    "alltoall": dict(lookup="alltoall"),
}


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)], ids=["2x1", "1x2", "2x2"])
def test_device_cache_under_dist_train_matches_jax(tmp_path, data, mesh):
    """The sharded resident epoch: each rank holds its rows of every batch;
    K = 1, K = 4 (a graph of 4 steps on the card), packed, fused and
    alltoall against the JAX package's cached dist_train on a mesh of the
    same shape; the rows case is bitwise the port's streamed dist_train on
    the same mesh (the same batches, another input path)."""
    cases = CACHED if mesh == (2, 2) else {n: CACHED[n] for n in ("rows", "k4")}
    cache = dict(device_cache=True, binary_cache=True)
    pairs = {name: _pair(tmp_path, data, f"c{name}", mesh, **cache, **kw)
             for name, kw in cases.items()}
    streamed = _kw(tmp_path, data, "streamed", data_parallel=mesh[0], row_parallel=mesh[1])
    shutil.copy(pairs["rows"][1]["model_file"], streamed["model_file"])
    jlogs = {name: _jax_run(jk, mesh) for name, (jk, _) in pairs.items()}
    runs = [(pk, True, None) for _, pk in pairs.values()] + [(streamed, True, None)]
    out = _spawn(tmp_path, mesh[0] * mesh[1], _train_job, runs)[0]
    for (name, (jk, pk)), res in zip(pairs.items(), out):
        assert any(f"rows resident, sharded over {mesh[0] * mesh[1]} devices" in line
                   for line in res["log"]), name
        _check_pair(jk, pk, jlogs[name], res["log"])
    a, b = _saved(pairs["rows"][1]["model_file"]), _saved(streamed["model_file"])
    for key in ("table", "table_accum", "step"):
        assert np.array_equal(a[key], b[key]), key
    assert _losses(pairs["rows"][1]["metrics_path"]) == _losses(streamed["metrics_path"])


@pytest.mark.parametrize("over", [{}, CACHED["k4"], CACHED["fused"]], ids=["k1", "k4", "fused"])
def test_world_size_one_cached_is_cached_train_bitwise(tmp_path, data, over):
    cache = dict(device_cache=True, binary_cache=True, delta_every_steps=3, **over)
    a = _kw(tmp_path, data, "t", **cache)
    b = _kw(tmp_path, data, "d", **cache)
    _init_npz(a["model_file"], a)
    shutil.copy(a["model_file"], b["model_file"])
    train(Config(**a).validate(), resume=True, device="cpu", log=quiet)
    dist_train(Config(**b).validate(), resume=True, device="cpu", log=quiet)
    assert _losses(a["metrics_path"]) == _losses(b["metrics_path"])
    x, y = _saved(a["model_file"]), _saved(b["model_file"])
    assert int(x["step"]) == int(y["step"]) == 20
    for key in ("table", "table_accum"):
        assert np.array_equal(x[key], y[key][: x[key].shape[0]]), key


# -- async and delta saves across two ranks -----------------------------------


def _restore_both(path, acc):
    """The logical arrays of ``path`` (its chain replayed) as the JAX package
    and the port restore them (``acc`` the run's accumulator)."""
    from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore
    from fast_tffm_tpu.models import FMModel
    from fast_tffm_tpu.trainer import init_state as jax_init
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint

    with np.load(path) as z:  # the saved vocabulary: a packed mesh pads it
        model = FMModel(vocabulary_size=z["table"].shape[0], factor_num=K)
    acc = "row" if acc == "fused" else acc
    j = jax_restore(path, jax_init(model, jax.random.key(0), 0.1, acc))
    p = restore_checkpoint(path, torch.device("cpu"),
                           accum_width=model.row_dim if acc == "element" else 1)
    return j, p


_CACHE = dict(device_cache=True, binary_cache=True)
# (mesh, config): the writer's gather of a delta's rows from one row shard
# (1 x 2 on two ranks), from ranks that hold no row shard of their own
# data group (2 x 1: the early return on data index 1), and the padded
# gather over a row group at 2 x 2 on the rows, packed and fused layouts.
ASYNC_CASES = {
    "streamed": ((1, 2), {}),
    "cached": ((1, 2), _CACHE),
    "2x1": ((2, 1), {}),
    "2x2": ((2, 2), {}),
    "2x2-packed": ((2, 2), CACHED["packed"]),
    "2x2-fused-cached": ((2, 2), {**_CACHE, **CACHED["fused"]}),
}


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_async_and_delta_across_ranks(tmp_path, data, case):
    """Two or four ranks: async full saves and a delta every 3 steps end
    bitwise the same run with synchronous full saves; a run aborted at step
    8 leaves base 3 + delta 6 with the cursor vector of every rank, which
    the JAX package restores bitwise as the port does, and --resume from it
    ends bitwise the uninterrupted run."""
    mesh, over = ASYNC_CASES[case]
    world = mesh[0] * mesh[1]
    jk, plain = _pair(tmp_path, data, "plain", mesh, save_every_epochs=1, epoch_num=2, **over)
    saves = dict(async_save=True, delta_every_steps=3)
    chained = dict(plain, model_file=str(tmp_path / "chain.ckpt"),
                   metrics_path=str(tmp_path / "chain.jsonl"), **saves)
    cut = dict(chained, model_file=str(tmp_path / "cut.ckpt"), metrics_path="")
    for kw in (chained, cut):
        shutil.copy(plain["model_file"], kw["model_file"])
    out = _spawn(tmp_path, world, _train_job,
                 [(plain, True, None), (chained, True, None), (cut, True, None, 8)])
    assert [r[2]["aborted"] for r in out] == [8] * world
    a, b = _saved(plain["model_file"]), _saved(chained["model_file"])
    for key in ("table", "table_accum", "step"):
        assert np.array_equal(a[key], b[key]), key
    assert _losses(plain["metrics_path"]) == _losses(chained["metrics_path"])
    ckpts = [r for r in map(json.loads, open(chained["metrics_path"])) if r["kind"] == "ckpt"]
    assert {r["mode"] for r in ckpts} >= {"full", "delta"}
    # The aborted run's chain: the base at 3 and the delta at 6.
    from fast_tffm_tpu_torch.checkpoint import read_delta_chain, read_input_cursor

    _, chain = read_delta_chain(cut["model_file"])
    assert [int(np.load(m["path"])["step"]) for m in chain] == [6]
    cursor = read_input_cursor(cut["model_file"])
    assert cursor["process_count"] == world
    assert [(h["epoch"], h["batch_in_epoch"]) for h in cursor["hosts"]] == [(0, 6)] * world
    j, p = _restore_both(cut["model_file"], plain.get("adagrad_accumulator", "element"))
    assert int(j.step) == p.step == 6
    assert np.array_equal(np.asarray(j.table), p.table.numpy())
    assert np.array_equal(np.asarray(j.table_opt.accum), p.table_accum.numpy())
    out = _spawn(tmp_path, world, _train_job, [(cut, True, None)])
    assert any("resuming input at epoch 0, batch 6" in line for line in out[0][0]["log"])
    c = _saved(cut["model_file"])
    for key in ("table", "table_accum", "step"):
        assert np.array_equal(a[key], c[key]), key


def test_a_jax_written_chain_resumes_in_two_ranks(tmp_path, data):
    """The JAX package's dist_train (mesh 1 x 2, delta every 3 steps) aborted
    at step 8 leaves base 3 + delta 6; two port ranks resume from it and
    end within the tolerances of the JAX package's uninterrupted run."""
    mesh = (1, 2)
    jk, pk = _pair(tmp_path, data, "jchain", mesh, delta_every_steps=3)
    whole = dict(jk, model_file=str(tmp_path / "jwhole.ckpt"),
                 metrics_path=str(tmp_path / "jwhole.jsonl"))
    shutil.copy(jk["model_file"], whole["model_file"])
    jlog = _jax_run(whole, mesh)

    def abort(step):
        if step >= 8:
            raise _Abort(step)

    with pytest.raises(_Abort):
        _jax_run(jk, mesh, step_hook=abort)
    shutil.copy(jk["model_file"], pk["model_file"])
    for path in glob.glob(glob.escape(jk["model_file"]) + ".delta-*"):
        shutil.copy(path, pk["model_file"] + path[len(jk["model_file"]):])
    out = _spawn(tmp_path, 2, _train_job, [(pk, True, None)])
    assert any("resuming input at epoch 0, batch 6" in line for line in out[0][0]["log"])
    p, j = _saved(pk["model_file"]), _saved(whole["model_file"])
    assert int(p["step"]) == int(j["step"]) == 20
    for key in ("table", "table_accum"):
        np.testing.assert_allclose(p[key][:V], j[key][:V], rtol=TABLE_RTOL, atol=TABLE_ATOL)
    # The resumed losses are the uninterrupted run's from step 7 on.
    np.testing.assert_allclose(_losses(pk["metrics_path"]), _losses(whole["metrics_path"])[6:],
                               rtol=LOSS_RTOL)
    assert _aucs(out[0][0]["log"]) and jlog
