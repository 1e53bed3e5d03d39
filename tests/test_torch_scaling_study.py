"""Port: tools/torch_scaling_study.py against the JAX package's
tools/scaling_study.py, on the CPU.

* Data: ``generate`` writes ``gen_synthetic.generate``'s bytes for the
  study's task (tools/torch_gen_synthetic.py; its own tests cover the
  blocks and the other shapes).
* Oracle: ``oracle_auc`` through the port's parser equals the JAX tool's
  through the JAX package's within 1e-12 on a small file.
* Config: a point's training Config has the JAX tool's fields and values
  (the JAX one captured by replacing ``fast_tffm_tpu.training.train``).
* Training: the point's config in both packages from one npz the JAX
  package saved, on a small split: every epoch's validation AUC within
  0.002, the tables within atol 1e-5 (tests/test_torch_models.py's
  train-parity drift).
* The whole tool at one small point on ``--device cpu``: its artifact's keys
  are the JAX artifact's (scaling_study.json) plus ``ADDED_KEYS``, its
  oracle the JAX artifact's printed one, the split files removed.
"""

import dataclasses
import filecmp
import json
import os
import shutil
import tempfile

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
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import jax_fields
from fast_tffm_tpu_torch.training import train
from tools import gen_synthetic
from tools import scaling_study as jstudy
from tools import torch_scaling_study as study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUC_TOL, TABLE_ATOL = 0.002, 1e-5


def _jax_generate(path, rows, seed):
    gen_synthetic.generate(path, rows=rows, fields=study.FIELDS, vocab=study.VOCAB, seed=seed,
                           factor_num=study.K_HIDDEN, spread=study.SPREAD)


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_writes_gen_synthetics_bytes(tmp_path, seed):
    study.generate(str(tmp_path / "p"), 2500, seed)
    _jax_generate(str(tmp_path / "j"), 2500, seed)
    assert filecmp.cmp(tmp_path / "p", tmp_path / "j", shallow=False)


def test_oracle_auc_is_the_jax_tools(tmp_path):
    path = str(tmp_path / "te.libsvm")
    study.generate(path, 20_000, seed=1)
    got, want = study.oracle_auc(path), jstudy.oracle_auc(path)
    assert abs(got - want) <= 1e-12
    assert 0.85 < got < 0.95


class _Captured(Exception):
    pass


def test_training_config_is_the_jax_tools(tmp_path, monkeypatch):
    seen = []

    def capture(cfg, **_):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jax_training, "train", capture)
    with pytest.raises(_Captured):
        jstudy.train_point(str(tmp_path), 500, "te.txt", 3, 0.5, 256)
    tr = os.path.join(str(tmp_path), "tr_500.libsvm")
    cfg = study.train_config(str(tmp_path), 500, tr, "te.txt", 3, 0.5, 256)
    assert jax_fields(cfg) == dataclasses.asdict(seen[0])


def test_point_trains_as_the_jax_package(tmp_path):
    """The point's config (lr 0.5, batch 1024) resumed in both packages from
    one JAX-saved npz on 3,000 rows, 2 epochs."""
    data = tmp_path / "data"
    data.mkdir()
    study.generate(str(data / "tr"), 3000, seed=0)
    study.generate(str(data / "te"), 1000, seed=1)
    cfgs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        shutil.copy(data / "tr", d / "tr")
        shutil.copy(data / "te", d / "te")
        cfgs[pkg] = study.train_config(str(d), 3000, str(d / "tr"), str(d / "te"), 2, 0.5, 1024)
    jcfg = JaxConfig(**jax_fields(cfgs["jax"])).validate()
    jmodel = jax_build_model(jcfg)
    state = jax_init_state(jmodel, jax.random.key(0), jcfg.init_accumulator_value, "element")
    table = np.random.default_rng(6).uniform(-0.05, 0.05, size=state.table.shape)
    jax_save_checkpoint(jcfg.model_file, state._replace(table=jnp.asarray(table, jnp.float32)))
    shutil.copy(jcfg.model_file, cfgs["port"].model_file)
    jax_training.train(jcfg, resume=True, log=lambda *_: None)
    train(cfgs["port"], resume=True, log=lambda *_: None, device="cpu")

    def aucs(path):
        with open(path) as f:
            return [r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r]

    got, want = aucs(cfgs["port"].metrics_path), aucs(jcfg.metrics_path)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=AUC_TOL)
    port = restore_checkpoint(cfgs["port"].model_file, torch.device("cpu"))
    jstate = jax_restore_checkpoint(jcfg.model_file, jax_init_state(jmodel, jax.random.key(0)))
    np.testing.assert_allclose(port.table.numpy(), np.asarray(jstate.table), atol=TABLE_ATOL)

@pytest.fixture
def one_torch_thread():
    """The whole tool on one intra-op thread: on a host whose cores are busy
    with other work, a pool of one thread per core waits at every parallel
    region on its slowest thread, and the run slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_point_run_artifact(tmp_path, monkeypatch, capsys, one_torch_thread):
    td = tmp_path / "td"
    td.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(td))
    out = tmp_path / "study.json"
    assert study.main(["--rows", "4096", "--epochs", "1", "--device", "cpu",
                       "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    with open(os.path.join(REPO, "scaling_study.json")) as f:
        committed = json.load(f)
    assert set(art) == set(committed) | set(study.ADDED_KEYS)
    (point,) = art["points"]
    assert set(point) == set(committed["points"][0])
    # The oracle depends only on numpy and the parse: the JAX artifact's.
    assert point["oracle_auc"] == committed["points"][0]["oracle_auc"] == 0.91053
    assert point["rows"] == 4096 and 0.5 < point["heldout_auc"] <= point["oracle_auc"]
    assert art["r1_points"] == committed["r1_points"]
    assert art["study"] == committed["study"].replace("epochs=4", "epochs=1")
    assert art["device"] == "cpu" and art["kernel_launches"]["rows_tail_adagrad"] == 0
    assert art["reduced"] == {
        "rows": {"default": study.DEFAULT_ROWS, "run": "4096",
                 "left_out": [2_400_000, 4_800_000, 9_600_000]},
        "epochs": {"default": 4, "run": 1}}
    assert os.listdir(td) == []  # the splits, their .fmb and the temp dir removed
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"oracle_auc": 0.91053} and lines[-1] == {"written": str(out)}
