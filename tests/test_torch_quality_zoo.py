"""Port: tools/torch_quality_zoo.py against the JAX package's tools/quality_zoo.py,
on the CPU.

* Data: each family's generated rows, labels, planted scores and file bytes
  equal the JAX tool's for the same seeds (``_gen_split``), and the oracle
  AUC of the port's ``metrics.auc`` equals the JAX one's.
* Config: each training run's Config has the JAX tool's fields and values
  (the JAX one captured by replacing ``fast_tffm_tpu.training.train``).
* Training: each family trains in both packages from one npz the JAX
  package saved (init draws differ across frameworks), a few thousand
  rows: every epoch's validation AUC within 0.002 and the tables (DeepFM's
  dense leaves too) within atol 1e-5, the float32 summation-order drift of
  tests/test_torch_models.py's train-parity tests.
* The whole tool at ``--quick --device cpu``: its artifact's keys are the
  JAX artifact's (QUALITY_ZOO_r05_48M.json, and QUALITY_ZOO_r05.json's
  DeepFM row) plus ``ADDED_KEYS``.
"""

import dataclasses
import filecmp
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_tffm_tpu.training as jax_training
from fast_tffm_tpu.checkpoint import restore_checkpoint as jax_restore_checkpoint
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.metrics import auc as jax_auc
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import build_model, jax_fields
from fast_tffm_tpu_torch.metrics import auc
from fast_tffm_tpu_torch.training import train
from tools import quality_zoo as jzoo
from tools import torch_quality_zoo as zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ROWS, TEST_ROWS = 2000, 1000
AUC_TOL, TABLE_ATOL = 0.002, 1e-5

# Each family as main() trains it: (scorer, fields, fmt, seeds, _train kwargs).
FAMILIES = {
    "ffm": (lambda i, v: zoo.planted_ffm_score(i, v, 8),
            lambda i, v: jzoo.planted_ffm_score(i, v, 8), 8, "libffm", (10, 11),
            dict(model="ffm", fields=8, epochs=2, lr=0.25)),
    "fm3": (zoo.planted_fm3_score, jzoo.planted_fm3_score, 12, "libsvm", (20, 21),
            dict(model="fm", fields=0, epochs=2, order=3, lr=0.25)),
    "deepfm": (zoo.planted_deep_score, jzoo.planted_deep_score, 12, "libsvm", (30, 31),
               dict(model="deepfm", fields=12, epochs=2, hidden=(64, 32), lr=0.05)),
    "fmbase": (zoo.planted_deep_score, jzoo.planted_deep_score, 12, "libsvm", (30, 31),
               dict(model="fm", fields=0, epochs=2, lr=0.1)),
}


def _split(tmp, name, which, rows, port=True):
    scorer, jscorer, fields, fmt, seeds, _ = FAMILIES[name]
    tag = f"{name}_{which}"
    seed = seeds[0 if which == "tr" else 1]
    if port:
        return zoo._gen_split(str(tmp), tag, scorer, fields, rows, seed, fmt)
    return jzoo._gen_split(str(tmp), tag, jscorer, fields, rows, seed, fmt)


@pytest.mark.parametrize("name", ["ffm", "fm3", "deepfm"])
def test_split_rows_scores_and_bytes_are_the_jax_tools(tmp_path, name):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    for which, rows in (("tr", 2000), ("te", 1000)):
        path, labels, score = _split(tmp_path / "port", name, which, rows)
        jpath, jlabels, jscore = _split(tmp_path / "jax", name, which, rows, port=False)
        np.testing.assert_array_equal(labels, jlabels)
        np.testing.assert_array_equal(score, jscore)
        assert filecmp.cmp(path, jpath, shallow=False)
        assert auc(labels, score) == jax_auc(jlabels, jscore)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("name", list(FAMILIES))
def test_training_config_is_the_jax_tools(tmp_path, monkeypatch, name):
    kw = FAMILIES[name][-1]
    seen = []

    def capture(cfg, **_):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jax_training, "train", capture)
    with pytest.raises(_Captured):
        jzoo._train(str(tmp_path), name, "tr.txt", "te.txt", **kw)
    cfg = zoo.train_config(str(tmp_path), name, "tr.txt", "te.txt", **kw)
    assert jax_fields(cfg) == dataclasses.asdict(seen[0])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_trains_as_the_jax_package(tmp_path, name):
    """From one JAX-saved npz (factors redrawn from a numpy seed), both
    packages resume the family's config on the same few thousand rows."""
    kw = FAMILIES[name][-1]
    data = tmp_path / "data"
    data.mkdir()
    tr, _, _ = _split(data, name, "tr", TRAIN_ROWS)
    te, _, _ = _split(data, name, "te", TEST_ROWS)
    runs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        # Each package its own copy of the text (each writes its .fmb cache).
        shutil.copy(tr, d / "tr")
        shutil.copy(te, d / "te")
        runs[pkg] = zoo.train_config(str(d), name, str(d / "tr"), str(d / "te"), **kw)
    jcfg = JaxConfig(**jax_fields(runs["jax"])).validate()
    jmodel = jax_build_model(jcfg)
    state = jax_init_state(jmodel, jax.random.key(0), jcfg.init_accumulator_value, "element")
    table = np.random.default_rng(5).uniform(-0.05, 0.05, size=state.table.shape)
    jax_save_checkpoint(jcfg.model_file, state._replace(table=jnp.asarray(table, jnp.float32)))
    shutil.copy(jcfg.model_file, runs["port"].model_file)

    jax_training.train(jcfg, resume=True, log=lambda *_: None)
    train(runs["port"], resume=True, log=lambda *_: None, device="cpu")

    def aucs(path):
        with open(path) as f:
            return [r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r]

    got, want = aucs(runs["port"].metrics_path), aucs(jcfg.metrics_path)
    assert len(got) == len(want) == kw["epochs"]
    np.testing.assert_allclose(got, want, atol=AUC_TOL)
    assert zoo.best_validation_auc(runs["port"].metrics_path) == max(got)
    model = build_model(runs["port"])
    port = restore_checkpoint(runs["port"].model_file, torch.device("cpu"),
                              n_dense=len(model.dense_names))
    jstate = jax_restore_checkpoint(jcfg.model_file, jax_init_state(jmodel, jax.random.key(0)))
    np.testing.assert_allclose(port.table.numpy(), np.asarray(jstate.table), atol=TABLE_ATOL)
    jdense = jax.tree.flatten(jstate.dense)[0]
    assert len(port.dense) == len(jdense) == (6 if name == "deepfm" else 0)
    for p, j in zip(port.dense, jdense):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=TABLE_ATOL)

@pytest.fixture
def one_torch_thread():
    """The whole tool on one intra-op thread: on a host whose cores are busy
    with other work, a pool of one thread per core waits at every parallel
    region on its slowest thread, and the run slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quick_run_artifact(tmp_path, capsys, one_torch_thread):
    out = tmp_path / "zoo.json"
    assert zoo.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    with open(os.path.join(REPO, "QUALITY_ZOO_r05_48M.json")) as f:
        committed = json.load(f)
    with open(os.path.join(REPO, "QUALITY_ZOO_r05.json")) as f:
        deep_keys = set(json.load(f)["families"]["deepfm"])
    assert set(art) == set(committed) | set(zoo.ADDED_KEYS)
    assert list(art["families"]) == ["ffm", "fm3", "deepfm"]
    for fam, rec in art["families"].items():
        assert set(rec) == (deep_keys if fam == "deepfm" else set(committed["families"][fam]))
        for key in ("heldout_auc", "fm_baseline_auc"):
            if key in rec:
                assert 0.5 < rec[key] <= rec["oracle_auc"] + 0.01, (fam, rec)
    assert art["device"] == "cpu" and art["card"] is None
    assert art["kernel_launches"] == {"anova_fwd": 0, "anova_bwd": 0, "rows_tail_adagrad": 0,
                                      "fused_tail_adagrad": 0, "fm2_fwd": 0, "fm2_bwd": 0,
                                      "dcn_cross_fwd": 0, "dcn_cross_bwd": 0}
    assert art["reduced"] == {"rows": {"default": 2_400_000, "run": 60_000},
                              "test_rows": {"default": 50_000, "run": 8_000},
                              "epochs": {"default": 6, "run": 2}}
    assert "wrote" in capsys.readouterr().out
