"""Port: bench_all_torch.py against the JAX package's bench_all.py.

* ``make_batch``'s arrays, bitwise for the same rng (with and without
  FFM fields).
* The sweep on the CPU at small sizes set through the module's constants:
  every row of bench_all.py's order (cfg1-cfg5, predict, the input and
  end-to-end rows, the convergence pair, the quality rows folded from the
  committed QUALITY_ZOO_TORCH_r17.json, the packed rows with their knee
  batches; the held-out line's converged point from
  SCALING_STUDY_TORCH_r17.json), the artifact rewritten after each row with
  the card stamp; exit 0.  A section that raises costs one FAILED
  row and the exit code is 1.
* Convergence, on one generated file each: the fit line's train AUC within
  0.02 of the JAX package's ``train`` under bench_all.py's fit config on
  the same file (the init draws differ between the packages); the
  held-out line's oracle AUC equal to the JAX oracle's (the planted
  model's scores through the JAX package's parser and ``auc``).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import bench_all
import bench_all_torch as ba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_ROWS, FIT_EPOCHS, HELDOUT_ROWS, TEST_ROWS = 1000, 10, 3000, 1000
FIT_AUC_TOL = 0.02


@pytest.mark.parametrize("num_fields,vocab", [(0, 1 << 20), (22, 1 << 10)])
def test_make_batch_bitwise(num_fields, vocab):
    want = bench_all.make_batch(np.random.default_rng(0), 64, 22, vocab, num_fields)
    got = ba.batch_arrays(np.random.default_rng(0), 64, 22, vocab, num_fields)
    tensors = ba.make_batch(np.random.default_rng(0), 64, 22, vocab, num_fields, "cpu")
    for name in ("labels", "ids", "vals", "fields", "weights"):
        w = np.asarray(getattr(want, name))
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w)
        np.testing.assert_array_equal(getattr(tensors, name).numpy(), w)


def _small(monkeypatch):
    for name, value in (("B", 128), ("VOCAB", 1 << 12), ("VOCAB_CFG2", 1 << 13),
                        ("INPUT_ROWS", 2000), ("E2E_ROWS", 2000), ("FIT_ROWS", FIT_ROWS),
                        ("FIT_EPOCHS", FIT_EPOCHS), ("HELDOUT_ROWS", HELDOUT_ROWS),
                        ("HELDOUT_TEST_ROWS", TEST_ROWS)):
        monkeypatch.setattr(ba, name, value)

@pytest.fixture
def one_torch_thread():
    """A sweep on one intra-op thread: on a host whose cores are busy
    with other work, a pool of one thread per core waits at every parallel
    region on its slowest thread, and the run slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_rows_and_artifact(tmp_path, monkeypatch, capsys, one_torch_thread):
    _small(monkeypatch)
    out = tmp_path / "bench_all.json"
    assert ba.main(["--device", "cpu", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    names = [r["metric"].split(":")[0] for r in art["results"]]
    assert names == ["cfg1", "cfg2", "cfg3", "cfg4", "cfg5", "predict ex/s/chip (FM order2 k=8, "
                     "nnz=39, vocab=1M)", "input", "input", "end-to-end", "end-to-end",
                     "convergence fit", "convergence heldout", "cfg3 quality", "cfg5 quality",
                     "cfg4 quality", "cfg1p", "cfg3p", "cfg3pb", "cfg4p", "cfg5p", "cfg2p"]
    assert all(r["value"] is not None and r["value"] > 0 for r in art["results"])
    for r in art["results"]:
        assert {"metric", "value", "unit", "vs_baseline"} <= set(r)
    knees = {r["metric"].split(":")[0]: r["knee_batch"] for r in art["results"]
             if "knee_batch" in r}
    assert knees == {"cfg1p": 512, "cfg3p": 256, "cfg3pb": 256, "cfg4p": 256, "cfg5p": 512,
                     "cfg2p": 512}
    assert all("knee_value" in r for r in art["results"] if "knee_batch" in r)
    assert art["generated_by"] == "bench_all_torch.py" and art["device"] == "cpu"
    assert art["card"] is None and "left_out" not in art
    # The folded rows: the committed card artifacts, each beside its source.
    rows = {r["metric"].split(":")[0]: r for r in art["results"]}
    for name in ("cfg3 quality", "cfg5 quality", "cfg4 quality"):
        assert rows[name]["source"].startswith("QUALITY_ZOO_TORCH_r17.json")
        assert 0.5 < rows[name]["value"] <= rows[name]["oracle_auc"]
    heldout = rows["convergence heldout"]
    assert heldout["converged_source"].startswith("SCALING_STUDY_TORCH_r17.json")
    assert heldout["measured_slice_this_run"]["rows"] == HELDOUT_ROWS
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metrics"] == 21 and last["failed"] == []


def test_failed_section_exits_nonzero(tmp_path, monkeypatch, one_torch_thread):
    _small(monkeypatch)
    for name in ("bench_input", "bench_end_to_end_ab", "bench_convergence"):
        monkeypatch.setattr(ba, name, lambda sw, *a, **kw: None)

    def broken(sw):
        raise RuntimeError("scorer lost")

    monkeypatch.setattr(ba, "bench_predict", broken)
    out = tmp_path / "bench_all.json"
    assert ba.main(["--device", "cpu", "--out", str(out)]) == 1
    rows = json.loads(out.read_text())["results"]
    failed = [r for r in rows if r["metric"].endswith("(FAILED)")]
    assert len(failed) == 1 and "scorer lost" in failed[0]["error"]
    assert failed[0]["value"] is None
    assert rows[-1]["metric"].startswith("cfg2p")  # the sweep went on


def test_failed_knee_exits_nonzero(tmp_path, monkeypatch, capsys):
    """A knee run that raises keeps its row (bench_all.py's ``knee_error``
    key beside the default batch's value) and the exit code is 1."""
    _small(monkeypatch)
    for name in ("bench_predict", "bench_input", "bench_end_to_end_ab", "bench_convergence"):
        monkeypatch.setattr(ba, name, lambda sw, *a, **kw: None)
    time_step = ba.time_step

    def knee_breaks(step, state, batches, **kw):
        if batches[0].ids.shape[0] == 4 * ba.B and batches[0].ids.shape[1] == 11:
            raise RuntimeError("launch failed")  # cfg5p's knee batch only
        return time_step(step, state, batches, **kw)

    monkeypatch.setattr(ba, "time_step", knee_breaks)
    out = tmp_path / "bench_all.json"
    assert ba.main(["--device", "cpu", "--out", str(out)]) == 1
    rows = {r["metric"].split(":")[0]: r for r in json.loads(out.read_text())["results"]}
    assert "launch failed" in rows["cfg5p"]["knee_error"] and rows["cfg5p"]["value"] > 0
    assert not any("knee_error" in r for k, r in rows.items() if k != "cfg5p")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(last["failed"]) == 1 and last["failed"][0].startswith("cfg5p")


def test_convergence_against_jax(tmp_path, monkeypatch):
    """The fit line against the JAX package's train on the same generated
    file; the oracle AUC equal."""
    from fast_tffm_tpu.config import Config as JaxConfig
    from fast_tffm_tpu.data.pipeline import batch_stream as jax_batch_stream
    from fast_tffm_tpu.metrics import auc as jax_auc
    from fast_tffm_tpu.training import train as jax_train

    _small(monkeypatch)
    sw = ba.Sweep(None, "", torch.device("cpu"))
    (tmp_path / "files").mkdir()
    ba.bench_convergence(sw, ba.synthetic_files(str(tmp_path / "files")))
    fit, heldout = sw.results
    assert fit["metric"].startswith("convergence fit")
    gen = ba._gen_tools()
    # The fit line's file and config, as bench_all.py's run() trains them.
    fit_tr = str(tmp_path / "fit.libsvm")
    gen.generate(fit_tr, rows=FIT_ROWS, fields=39, vocab=1 << 14, seed=0, factor_num=4)
    metrics = str(tmp_path / "metrics_fit.jsonl")
    cfg = JaxConfig(model="fm", factor_num=8, vocabulary_size=1 << 14,
                    model_file=str(tmp_path / "m_fit.ckpt"), train_files=(fit_tr,),
                    validation_files=(fit_tr,), epoch_num=FIT_EPOCHS, batch_size=512,
                    learning_rate=0.5, log_every=10**9, metrics_path=metrics,
                    binary_cache=True).validate()
    jax_train(cfg, log=lambda *_: None)
    with open(metrics) as f:
        jax_fit = max(r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r)
    assert abs(fit["value"] - jax_fit) <= FIT_AUC_TOL, (fit["value"], jax_fit)
    assert fit["value"] >= 0.95
    # The held-out line's oracle: the planted model on the same test file.
    te = str(tmp_path / "te.libsvm")
    gen.generate(te, rows=TEST_ROWS, fields=39, vocab=1 << 14, seed=1, factor_num=4,
                 spread=3.0)
    labels, scores = [], []
    for b, w in jax_batch_stream([te], batch_size=8192, vocabulary_size=1 << 14, max_nnz=39):
        n = int((w > 0).sum())
        scores.append(gen.planted_score(np.asarray(b.ids)[:n], b.vals[:n], factor_num=4))
        labels.append(b.labels[:n])
    jax_oracle = round(float(jax_auc(np.concatenate(labels), np.concatenate(scores))), 5)
    assert heldout["measured_slice_this_run"]["oracle_auc"] == jax_oracle
    assert heldout["measured_slice_this_run"]["rows"] == HELDOUT_ROWS
    assert 0.5 < heldout["value"] <= 1.0


def test_needs_a_card_or_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ba.main(["--out", str(tmp_path / "x.json")])
    assert sys.modules["bench_all_torch"] is ba
