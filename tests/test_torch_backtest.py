"""Port: tools/torch_backtest.py against the JAX package's tools/backtest.py,
on the CPU.

* Data: each hour's rows, labels and libsvm bytes equal the JAX tool's
  (``_gen_hour``), and so do the FMS stream's bytes from the port's
  ``StreamWriter``.
* Config: the online (follow) and batch Configs have the JAX tool's fields
  and values (the JAX ones captured by replacing
  ``fast_tffm_tpu.training.train``; the run id is each run's own).
* Training: two hours through the batch config and through the online
  follow config (the second hour resumed mid-stream) in both packages from
  one npz the JAX package saved: the tables within atol 1e-5
  (tests/test_torch_models.py's train-parity drift), each next-hour AUC
  within 0.002.
* ``_auc_on`` of one shared checkpoint within 1e-6 of the JAX tool's.
* The whole tool at ``--quick --device cpu``: exit 0, gate OK, its
  artifact's keys the JAX artifact's (BACKTEST_r11.json) plus ``ADDED_KEYS``.
"""

import argparse
import dataclasses
import filecmp
import importlib
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
from fast_tffm_tpu.data.stream import StreamWriter as JaxStreamWriter
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import jax_fields
from fast_tffm_tpu_torch.data.stream import StreamWriter
from fast_tffm_tpu_torch.training import train
from tools import torch_backtest as bt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUC_TOL, TABLE_ATOL = 0.002, 1e-5
ARGS = argparse.Namespace(batch_size=256, lr=0.1, decay=0.999, batch_epochs=2)


@pytest.fixture(scope="module")
def jbt():
    """The JAX tool; it arms a 3600 s hang-exit timer when imported, which
    its main() cancels, so it is cancelled here at once."""
    mod = importlib.import_module("tools.backtest")
    mod._HANG_TIMER.cancel()
    return mod


@pytest.mark.parametrize("hour", [0, 7, 23])
def test_hour_rows_and_bytes_are_the_jax_tools(tmp_path, jbt, hour):
    for rows, seed in ((1024, 11), (512, 11 + 1_000_003)):
        got, want = bt._gen_hour(hour, 24, rows, seed), jbt._gen_hour(hour, 24, rows, seed)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        bt.write_rows(str(tmp_path / "p"), *got, "libsvm")
        jbt._write_libsvm(str(tmp_path / "j"), *want)
        assert filecmp.cmp(tmp_path / "p", tmp_path / "j", shallow=False)


def test_stream_bytes_are_the_jax_writers(tmp_path, jbt):
    paths = {"port": str(tmp_path / "p.fms"), "jax": str(tmp_path / "j.fms")}
    writers = {"port": StreamWriter(paths["port"], width=bt.FIELDS, vocabulary_size=bt.VOCAB),
               "jax": JaxStreamWriter(paths["jax"], width=bt.FIELDS, vocabulary_size=bt.VOCAB)}
    for h in range(3):
        labels, ids, vals = bt._gen_hour(h, 3, 512, 11)
        for w in writers.values():
            w.append(labels, ids, vals.astype(np.float32))
    for w in writers.values():
        w.close()
    assert filecmp.cmp(paths["port"], paths["jax"], shallow=False)


class _Captured(Exception):
    pass


def test_configs_are_the_jax_tools(tmp_path, monkeypatch, jbt):
    seen = []

    def capture(cfg, **_):
        seen.append(cfg)
        if len(seen) == 2:
            raise _Captured

    monkeypatch.setattr(jax_training, "train", capture)
    with pytest.raises(_Captured):
        jbt.main(["--quick", "--decay", "0.999", "--batch-epochs", "2", "--keep-dir",
                  str(tmp_path), "--out", str(tmp_path / "x.json")])
    jon, jba = seen
    hour0 = [os.path.join(str(tmp_path), "hour_00.libsvm")]
    run_id = jon.telemetry_run_id
    on = bt.online_config(str(tmp_path), os.path.join(str(tmp_path), "day.fms"), 4, ARGS, run_id)
    ba = bt.batch_config(str(tmp_path), hour0, ARGS, run_id)
    assert jax_fields(on) == dataclasses.asdict(jon)
    assert jax_fields(ba) == dataclasses.asdict(jba)


def _shared_npz(cfg, path, seed):
    jcfg = JaxConfig(**dict(jax_fields(cfg), model_file=path)).validate()
    jmodel = jax_build_model(jcfg)
    state = jax_init_state(jmodel, jax.random.key(0), jcfg.init_accumulator_value, "element")
    table = np.random.default_rng(seed).uniform(-0.01, 0.01, size=state.table.shape)
    jax_save_checkpoint(path, state._replace(table=jnp.asarray(table, jnp.float32)))
    return jmodel


def _tables_close(port_cfg, jax_cfg, jmodel):
    port = restore_checkpoint(port_cfg.model_file, torch.device("cpu"), accum_width=bt.K + 1)
    jstate = jax_restore_checkpoint(jax_cfg.model_file, jax_init_state(jmodel, jax.random.key(0)))
    np.testing.assert_allclose(port.table.numpy(), np.asarray(jstate.table), atol=TABLE_ATOL)
    np.testing.assert_allclose(port.table_accum.numpy(), np.asarray(jstate.table_opt.accum),
                               atol=TABLE_ATOL)
    assert port.step == int(jstate.step)


def test_hours_train_as_the_jax_package(tmp_path, jbt):
    """Two hours, 1,024 rows each: the batch reference on both files and the
    online trainer following the stream (hour 1 resumed at its cursor), in
    both packages from one JAX-saved npz; each model's AUC on hour 2."""
    dirs = {p: tmp_path / p for p in ("jax", "port")}
    cfgs = {}
    for pkg, d in dirs.items():
        d.mkdir()
        writer = StreamWriter(str(d / "day.fms"), width=bt.FIELDS, vocabulary_size=bt.VOCAB)
        hours = []
        for h in range(2):
            labels, ids, vals = bt._gen_hour(h, 3, 1024, 11)
            writer.append(labels, ids, vals)
            hours.append(str(d / f"hour_{h:02d}.libsvm"))
            bt.write_rows(hours[-1], labels, ids, vals, "libsvm")
        writer.close()
        cfgs[pkg] = {"batch": bt.batch_config(str(d), hours, ARGS, "r"),
                     **{f"online{h}": bt.online_config(str(d), str(d / "day.fms"), 4 * (h + 1),
                                                       ARGS, "r") for h in range(2)}}
    nxt = str(tmp_path / "heldout_02.libsvm")
    bt.write_rows(nxt, *bt._gen_hour(2, 3, 1024, 11 + 1_000_003), "libsvm")
    jcfg = {k: JaxConfig(**jax_fields(c)).validate() for k, c in cfgs["jax"].items()}
    for kind, seed in (("batch", 8), ("online0", 9)):
        jmodel = _shared_npz(jcfg[kind], jcfg[kind].model_file, seed)
        shutil.copy(jcfg[kind].model_file, cfgs["port"][kind].model_file)
    quiet = lambda *_: None  # noqa: E731
    for kind in ("batch", "online0", "online1"):
        jax_training.train(jcfg[kind], resume=True, log=quiet)
        train(cfgs["port"][kind], resume=True, log=quiet, device="cpu")
    for kind in ("batch", "online1"):
        _tables_close(cfgs["port"][kind], jcfg[kind], jmodel)
    cpu = torch.device("cpu")
    for kind in ("batch", "online1"):
        got = bt._auc_on(cfgs["port"][kind], nxt, bt.FIELDS, cpu)
        assert abs(got - jbt._auc_on(jcfg[kind], nxt, bt.FIELDS)) <= AUC_TOL
        assert 0.5 < got < 1.0


def test_auc_on_one_checkpoint_is_the_jax_tools(tmp_path, jbt):
    cfg = bt.batch_config(str(tmp_path), [str(tmp_path / "unused")], ARGS, "r")
    _shared_npz(cfg, cfg.model_file, 10)
    heldout = str(tmp_path / "heldout.libsvm")
    bt.write_rows(heldout, *bt._gen_hour(4, 24, 2048, 11 + 1_000_003), "libsvm")
    jcfg = JaxConfig(**jax_fields(cfg)).validate()
    got = bt._auc_on(cfg, heldout, bt.FIELDS, torch.device("cpu"))
    want = float(jbt._auc_on(jcfg, heldout, bt.FIELDS))
    assert abs(got - want) <= 1e-6
    assert got != 0.5

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
    out = tmp_path / "bt.json"
    assert bt.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    with open(os.path.join(REPO, "BACKTEST_r11.json")) as f:
        committed = json.load(f)
    assert set(art) == set(committed) | set(bt.ADDED_KEYS)
    assert art["gate"] == "OK" and art["hours"] == 3 and len(art["auc_by_hour"]) == 2
    assert [set(r) for r in art["auc_by_hour"]] == [set(committed["auc_by_hour"][0])] * 2
    assert art["device"] == "cpu" and art["kernel_launches"]["rows_tail_adagrad"] == 0
    assert art["reduced"] == {"hours": {"default": 24, "run": 3},
                              "rows_per_hour": {"default": 4096, "run": 1024},
                              "heldout_rows": {"default": 2048, "run": 512},
                              "batch_size": {"default": 512, "run": 256}}
    printed = capsys.readouterr().out
    assert "hour 02:" in printed and "(gate: OK)" in printed
