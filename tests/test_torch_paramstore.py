"""Port: the tiered parameter store (paramstore/), against fast_tffm_tpu/paramstore/.

Mirrors tests/test_paramstore.py:

* ``hashed_uniform_rows``, ``ResidencyMap.resolve`` and ``choose_hot_ids``
  give the JAX package's arrays; a store created by either package opens
  in the other, rows and ``applied_sig`` agreeing.  Tolerance: none.
* Port tiered training is bitwise port resident training at a vocabulary
  both hold: streamed K = 1 (losses, validation AUC, the logical table and
  accumulator rebuilt from both tiers), FMB K = 2, the row accumulator, and
  a cold hot set that forces coherency restages.
* Across packages (FM, a lazy store: both start from the same hashed
  init): a fresh port run against a fresh JAX run, and a run stopped after
  epoch 1 by one package and resumed by the other against the other
  package's uninterrupted run, losses rtol 1e-5 and tables atol 1e-5
  (tests/test_torch_training.py's tolerances: the summation orders differ).
* A ``cli train --fault-plan kill_writeback@1`` child leaves a loadable
  chain whose resume ends bitwise the uninterrupted run; a replaced store
  is refused; a resident restore refuses a tiered npz; a 2^30-row lazy
  store trains with sparse files; kind=tiering records carry the JAX keys;
  every JAX ``[ParamStore]`` refusal is the port's, word for word.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.paramstore import ColdStore as JaxColdStore
from fast_tffm_tpu.paramstore import hashed_uniform_rows as jax_hashed_uniform_rows
from fast_tffm_tpu.paramstore.residency import ResidencyMap as JaxResidencyMap
from fast_tffm_tpu.paramstore.residency import choose_hot_ids as jax_choose_hot_ids
from fast_tffm_tpu.telemetry import SCHEMAS as JAX_SCHEMAS
from fast_tffm_tpu.training import train as jax_train
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.paramstore import ColdStore, hashed_uniform_rows
from fast_tffm_tpu_torch.paramstore.residency import ResidencyMap, choose_hot_ids
from fast_tffm_tpu_torch.prediction import predict
from fast_tffm_tpu_torch.training import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 300
CPU = torch.device("cpu")


def _write_dataset(path, n=300, vocab=VOCAB, nnz=6, seed=0):
    """Synthetic libsvm rows with a skewed id head (tests/test_paramstore.py's
    generator): a small hot tier absorbs part of the traffic."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            head = rng.integers(0, 20, size=nnz // 2)
            tail = rng.integers(0, vocab, size=nnz - nnz // 2)
            ids = np.unique(np.concatenate([head, tail]))[:nnz]
            while ids.size < nnz:
                ids = np.unique(np.concatenate([ids, rng.integers(0, vocab, size=nnz)]))[:nnz]
            vals = np.round(np.abs(rng.normal(size=nnz)) + 0.1, 4)
            y = int(rng.random() < 0.5)
            f.write(f"{y} " + " ".join(f"{i}:{v}" for i, v in zip(ids, vals)) + "\n")


@pytest.fixture
def ds(tmp_path):
    _write_dataset(str(tmp_path / "train.libsvm"))
    _write_dataset(str(tmp_path / "valid.libsvm"), n=100, seed=9)
    return tmp_path


def _kw(tmp_path, name, **kw):
    base = dict(model="fm", factor_num=4, vocabulary_size=VOCAB,
                train_files=(str(tmp_path / "train.libsvm"),), epoch_num=2, batch_size=32,
                learning_rate=0.1, log_every=1, save_every_epochs=1,
                model_file=str(tmp_path / f"{name}.ckpt"))
    base.update(kw)
    return base


def _cfg(tmp_path, name, **kw):
    return Config(**_kw(tmp_path, name, **kw)).validate()


def _losses(logs):
    return [float(x.split("loss ")[1].split()[0]) for x in logs if "loss " in x]


def _aucs(logs):
    return [x for x in logs if "validation auc" in x]


def _run(cfg, **kw):
    logs = []
    state = train(cfg, log=lambda *a: logs.append(" ".join(map(str, a))), device="cpu", **kw)
    return state, logs


def _jax_run(kw, **run_kw):
    logs = []
    cfg = JaxConfig(**kw, telemetry_profile_costs=False).validate()
    jax_train(cfg, log=lambda *a: logs.append(" ".join(map(str, a))), **run_kw)
    return logs


def _tiered_logical(model_file, vocab=VOCAB, store_dir=None):
    """The full logical (table, accum) of a finished tiered run: the cold
    store, the npz's pending members over it, its hot tier over both."""
    z = np.load(model_file)
    store = ColdStore.open(store_dir or model_file + ".store")
    t, a = store.read_rows(np.arange(vocab))
    ci = np.asarray(z["tier_cold_idx"], np.int64)
    if ci.size:
        t[ci] = z["tier_cold_rows"]
        a[ci] = z["tier_cold_accum"]
    hi = np.asarray(z["tier_hot_ids"], np.int64)
    t[hi] = z["table"]
    a[hi] = z["table_accum"]
    return t, a


# -- cold store and residency, array for array ------------------------------


@pytest.mark.parametrize("seed,dim,rng_", [(0, 9, 0.01), (3, 5, 0.5), (11, 89, 0.02)])
def test_hashed_uniform_rows_are_jaxs(seed, dim, rng_):
    ids = np.random.default_rng(seed).integers(0, 2**31 - 1, size=257)
    got = hashed_uniform_rows(ids, dim, seed, rng_)
    want = jax_hashed_uniform_rows(ids, dim, seed, rng_)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("creator", ["jax", "port"])
@pytest.mark.parametrize("materialized", [False, True])
def test_store_opens_in_either_package(tmp_path, creator, materialized):
    rng = np.random.default_rng(5)
    kw = dict(vocab=1000, row_dim=5, accum_width=5, seed=3, init_range=0.02, init_accum=0.1)
    if materialized:
        kw.update(init_table=rng.uniform(-1, 1, (1000, 5)).astype(np.float32),
                  init_accum_arr=rng.uniform(0, 1, (1000, 5)).astype(np.float32))
    make, other = (JaxColdStore, ColdStore) if creator == "jax" else (ColdStore, JaxColdStore)
    s = make.create(str(tmp_path / "store"), **kw)
    s.write_rows(np.array([7, 400]), np.full((2, 5), 2.0), np.full((2, 5), 3.0))
    s.flush()
    s.set_applied("sig-1")
    o = other.open(str(tmp_path / "store"))
    ids = np.array([0, 7, 399, 400, 999])
    for got, want in zip(o.read_rows(ids), ColdStore.open(str(tmp_path / "store")).read_rows(ids)):
        assert got.tobytes() == want.tobytes()
    assert o.applied_sig == "sig-1" and o.fingerprint == s.fingerprint
    o.write_rows(np.array([1]), np.full((1, 5), 4.0), np.full((1, 5), 5.0))
    o.flush()
    for got, want in zip(make.open(str(tmp_path / "store")).read_rows(np.array([1, 7])),
                         o.read_rows(np.array([1, 7]))):
        assert got.tobytes() == want.tobytes()
    for name in ("table.dat", "accum.dat", "written.dat"):
        assert os.path.getsize(tmp_path / "store" / name) == {
            "table.dat": 1000 * 5 * 4, "accum.dat": 1000 * 5 * 4, "written.dat": 125}[name]


@pytest.mark.parametrize("hot", [0, 1, 40, 299])
def test_resolve_is_jaxs(hot):
    rng = np.random.default_rng(hot)
    hot_ids = rng.choice(VOCAB, size=hot, replace=False)
    seq = [rng.integers(0, VOCAB, size=(8, 6)) for _ in range(3)]
    got = ResidencyMap(hot_ids).resolve(seq, miss_capacity=VOCAB)
    want = JaxResidencyMap(hot_ids).resolve(seq, miss_capacity=VOCAB)
    for g, w in zip(got.remapped, want.remapped):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(got.miss_ids, want.miss_ids)
    assert got[2:] == want[2:]
    if got.miss_ids.size > 1:
        with pytest.raises(ValueError, match="miss_rows") as e:
            ResidencyMap(hot_ids).resolve(seq, miss_capacity=1)
        with pytest.raises(ValueError, match="miss_rows") as je:
            JaxResidencyMap(hot_ids).resolve(seq, miss_capacity=1)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("policy", ["first", "sample", "sample_short", "npy", "text", "nope"])
def test_choose_hot_ids_is_jaxs(tmp_path, policy):
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 50, size=(8, 6)) for _ in range(3)]
    k = 12
    if policy.startswith("sample"):
        if policy == "sample_short":
            batches = [np.array([5, 5, 9])]
        args = ("sample", k, 100)
        kw = lambda: dict(sample_batches=iter(batches))  # noqa: E731
    elif policy == "npy":
        np.save(tmp_path / "hot.npy", rng.integers(0, 120, size=60))
        args, kw = (f"file:{tmp_path / 'hot.npy'}", k, 100), dict
    elif policy == "text":
        (tmp_path / "hot.txt").write_text("42\n42\n17\n3\n" + "\n".join(map(str, range(20))))
        args, kw = (f"file:{tmp_path / 'hot.txt'}", k, 100), dict
    else:
        args, kw = (policy, k, 100), dict
    if policy == "nope":
        for fn in (choose_hot_ids, jax_choose_hot_ids):
            with pytest.raises(ValueError, match="residency"):
                fn(*args)
        return
    got, want = choose_hot_ids(*args, **kw()), jax_choose_hot_ids(*args, **kw())
    assert got.dtype == want.dtype and np.array_equal(got, want) and got.size == k


# -- tiered == resident, bit for bit -------------------------------------------


TIERED_CASES = {
    "streamed_k1": (dict(paramstore_hot_rows=48, delta_every_steps=3), {}),
    "fmb_k2": (dict(paramstore_hot_rows=48, delta_every_steps=4),
               dict(steps_per_call=2, binary_cache=True)),
    "row_accumulator": (dict(paramstore_hot_rows=32), dict(adagrad_accumulator="row")),
    "restage": (dict(paramstore_hot_rows=8), {}),
}


@pytest.mark.parametrize("case", list(TIERED_CASES))
def test_tiered_is_resident_bitwise(ds, case):
    tier_kw, common = TIERED_CASES[case]
    valid = (str(ds / "valid.libsvm"),)
    if case == "restage":
        # A hot set of ids the data never holds: every id stages, and with
        # the queue running ahead consecutive repeats go stale and restage.
        (ds / "hot.txt").write_text("\n".join(str(i) for i in range(290, 299)))
        tier_kw = dict(tier_kw, paramstore_residency=f"file:{ds / 'hot.txt'}",
                       metrics_path=str(ds / "m.jsonl"))
    res_cfg = _cfg(ds, "resident", validation_files=valid, **common)
    _s, res_logs = _run(res_cfg)
    tier_cfg = _cfg(ds, "tiered", validation_files=valid, paramstore=True, **tier_kw, **common)
    _s, tier_logs = _run(tier_cfg)
    assert _losses(res_logs) == _losses(tier_logs) and len(_losses(res_logs)) >= 8
    assert _aucs(res_logs) == _aucs(tier_logs) and _aucs(res_logs)
    ref = restore_checkpoint(res_cfg.model_file, CPU, accum_width=res_cfg.adagrad_accumulator
                             == "element" and 5 or 1)
    t, a = _tiered_logical(tier_cfg.model_file)
    assert np.array_equal(t, ref.table.numpy()) and np.array_equal(a, ref.table_accum.numpy())
    if case == "restage":
        recs = [json.loads(x) for x in open(ds / "m.jsonl") if x.strip()]
        tier = [r for r in recs if r["kind"] == "tiering"]
        assert tier and sum(r["restages"] for r in tier) > 0
        assert all(r["hit_rate"] <= 0.05 for r in tier)


# -- across packages -----------------------------------------------------------


LAZY = dict(paramstore=True, paramstore_hot_rows=48, paramstore_materialize="never",
            delta_every_steps=3)


def _close(port_logs, jax_logs, port_file, jax_file):
    np.testing.assert_allclose(_losses(port_logs), _losses(jax_logs), rtol=1e-5)
    for got, want in zip(_tiered_logical(port_file), _tiered_logical(jax_file)):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_fresh_lazy_tiered_run_matches_jax(ds):
    _s, port_logs = _run(_cfg(ds, "port", **LAZY))
    jax_logs = _jax_run(_kw(ds, "jax", **LAZY))
    assert len(_losses(port_logs)) == len(_losses(jax_logs)) >= 16
    _close(port_logs, jax_logs, str(ds / "port.ckpt"), str(ds / "jax.ckpt"))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(ds, first):
    """One package trains epoch 1 and saves; the other resumes at the cursor
    and trains epoch 2, ending within tolerance of the resuming package's
    uninterrupted run."""
    kw = _kw(ds, "split", **LAZY)
    one = dict(kw, epoch_num=1)
    if first == "jax":
        _jax_run(one)
        _s, part2 = _run(Config(**kw).validate(), resume=True)
        _s, ref = _run(_cfg(ds, "ref", **LAZY))
        ref_file = str(ds / "ref.ckpt")
    else:
        _run(Config(**one).validate())
        part2 = _jax_run(kw, resume=True)
        ref = _jax_run(_kw(ds, "ref", **LAZY))
        ref_file = str(ds / "ref.ckpt")
    assert any("resumed tiered run" in x for x in part2)
    lr, l2 = _losses(ref), _losses(part2)
    np.testing.assert_allclose(l2, lr[len(lr) - len(l2):], rtol=1e-5)
    for got, want in zip(_tiered_logical(kw["model_file"]), _tiered_logical(ref_file)):
        np.testing.assert_allclose(got, want, atol=1e-5)


# -- crash consistency, refusals, the large lazy store -------------------------


def _ini(path, kw):
    sections = {
        "General": dict(model="fm", factor_num=kw["factor_num"],
                        vocabulary_size=kw["vocabulary_size"], model_file=kw["model_file"]),
        "Train": dict(train_files=kw["train_files"][0], epoch_num=kw["epoch_num"],
                      batch_size=kw["batch_size"], learning_rate=kw["learning_rate"],
                      log_every=kw["log_every"], save_every_epochs=kw["save_every_epochs"]),
        "Checkpoint": dict(delta_every_steps=kw["delta_every_steps"]),
        "ParamStore": dict(enabled="true", hot_rows=kw["paramstore_hot_rows"]),
    }
    with open(path, "w") as f:
        for name, keys in sections.items():
            f.write(f"[{name}]\n" + "".join(f"{k} = {v}\n" for k, v in keys.items()))
    return str(path)


def test_kill_during_writeback_apply_resumes_bitwise(ds):
    kw = _kw(ds, "t_kill", paramstore=True, paramstore_hot_rows=48, delta_every_steps=3)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train", _ini(ds / "kill.cfg", kw),
         "--device", "cpu", "--fault-plan", "kill_writeback@1"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stdout, r.stderr)
    assert "injected_kill_writeback" in r.stderr or "fault plan armed" in r.stderr
    _s, part2 = _run(Config(**kw).validate(), resume=True)
    ref_kw = dict(kw, model_file=str(ds / "t_ref.ckpt"))
    _s, ref = _run(Config(**ref_kw).validate())
    lr, l2 = _losses(ref), _losses(part2)
    assert l2 and l2 == lr[len(lr) - len(l2):]
    for got, want in zip(_tiered_logical(kw["model_file"]),
                         _tiered_logical(ref_kw["model_file"])):
        assert np.array_equal(got, want)


def test_replaced_store_refused_and_resident_restores_refuse_tiered(ds):
    cfg = _cfg(ds, "t_swap", paramstore=True, paramstore_hot_rows=32)
    _run(cfg)
    with pytest.raises(ValueError, match="TIERED") as e:
        restore_checkpoint(cfg.model_file, CPU, accum_width=5)
    assert "predict/serve need a resident export" in str(e.value)
    pcfg = Config(**_kw(ds, "t_swap", predict_files=(str(ds / "valid.libsvm"),),
                        score_path=str(ds / "s.txt"))).validate()
    with pytest.raises(ValueError, match="TIERED"):
        predict(pcfg, device="cpu", log=lambda *_: None)
    from fast_tffm_tpu_torch.serving import ServingEngine

    with pytest.raises(ValueError, match="TIERED"):
        ServingEngine(pcfg, log=lambda *_: None, device="cpu")
    shutil.rmtree(cfg.model_file + ".store")
    ColdStore.create(cfg.model_file + ".store", vocab=VOCAB, row_dim=5, accum_width=5,
                     seed=0, init_range=0.01, init_accum=0.1)
    with pytest.raises(ValueError, match="store was replaced"):
        train(cfg, resume=True, log=lambda *a: None, device="cpu")


def test_beyond_hbm_vocab_trains_on_a_sparse_lazy_store(tmp_path):
    big = tmp_path / "big.libsvm"
    rng = np.random.default_rng(1)
    with open(big, "w") as f:
        for _ in range(64):
            f.write("1 " + " ".join(f"{i}:1.0" for i in rng.integers(0, 1 << 30, size=4)) + "\n")
    cfg = Config(model="fm", factor_num=4, vocabulary_size=1 << 30, train_files=(str(big),),
                 epoch_num=1, batch_size=16, log_every=1, learning_rate=0.1,
                 model_file=str(tmp_path / "big.ckpt"), paramstore=True,
                 paramstore_hot_rows=32, delta_every_steps=2,
                 adagrad_accumulator="row").validate()
    _s, logs = _run(cfg)
    losses = _losses(logs)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert any("lazy cold store" in x for x in logs)
    st = os.stat(os.path.join(cfg.model_file + ".store", "table.dat"))
    assert st.st_size == (1 << 30) * 5 * 4
    assert st.st_blocks * 512 < 64 << 20, "store file is not sparse"


def test_tiering_records_carry_the_jax_keys(ds):
    cfg = _cfg(ds, "t_tel", paramstore=True, paramstore_hot_rows=48, delta_every_steps=3,
               metrics_path=str(ds / "tel.jsonl"))
    _run(cfg)
    recs = [json.loads(x) for x in open(ds / "tel.jsonl") if x.strip()]
    tier = [r for r in recs if r["kind"] == "tiering"]
    # A record at every log point that has news: the prefetch thread resolves
    # ahead, so a window holds what it resolved since the last one.
    assert {r["epoch"] for r in tier} == {0, 1}
    for r in tier:
        assert not [k for k in JAX_SCHEMAS["tiering"] if k not in r]
        assert 0.0 < r["hit_rate"] <= 1.0
    summary = [r for r in recs if r["kind"] == "summary"][-1]
    assert summary["tier_miss_rows"] > 0 and summary["tier_writeback_rows"] > 0
    assert not [r for r in recs if r["kind"] == "compile" and not r.get("warmup")]


@pytest.mark.parametrize("kw,needle", [
    (dict(table_layout="packed"), "table_layout = rows"),
    (dict(checkpoint_format="orbax"), "npz"),
    (dict(device_cache=True), "device_cache"),
    (dict(online_follow=True), r"\[Online\] follow"),
    (dict(async_save=True), "async_save"),
    (dict(table_layout="packed", adagrad_accumulator="fused"), "table_layout = rows"),
    (dict(adagrad_accumulator="fused"), "table_layout = packed"),
    (dict(on_nan="rollback"), "rollback"),
    (dict(online_accum_restart_steps=4), "accum_restart_steps"),
    (dict(dedup_gather_rows=8), "redundant"),
    (dict(paramstore_hot_rows=0), "hot_rows"),
    (dict(paramstore_miss_rows=-1), "miss_rows"),
    (dict(paramstore_sample_batches=0), "sample_batches"),
    (dict(paramstore_residency="hot"), "residency"),
    (dict(paramstore_residency="file:"), "residency"),
    (dict(paramstore_materialize="sometimes"), "materialize"),
    (dict(paramstore=False, tail="pallas", dedup_gather_rows=64), "tail = pallas"),
])
def test_paramstore_refusals_are_jaxs(kw, needle):
    kw = dict(dict(paramstore=True, train_files=("x.libsvm",)), **kw)
    errors = []
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match=needle) as e:
            cls(**kw).validate()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    Config(paramstore=True, train_files=("x.libsvm",)).validate()  # the plain enablement
