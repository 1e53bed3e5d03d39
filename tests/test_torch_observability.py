"""Port: profiling, id statistics, tracing and the serving/predict records,
against the JAX package, on the CPU.

* ``parse_profile_steps`` gives the JAX function's answers and errors;
  ``modeled_step_bytes`` its numbers.
* ``DataStatsCollector`` gives the JAX collector's integer statistics (ids,
  unique, rows seen, the heavy-hitter bucket counts) and so the same
  ratios, on the same batches; a skewed stream shows the skew.
* Instrumented runs: the streamed and the device-cached (K = 4) paths emit
  one kind=profile record per step program (flops and bytes null: the port
  has no compiler cost model), kind=datastats, and no steady-state compile;
  ``profile_steps`` brackets a torch.profiler trace with start and stop
  records and writes it; ``trace_dir`` writes a window trace.
* predict writes kind=predict, kind=input and a ``predict_step`` profile
  record; the serving engine writes kind=serving at ``metrics_every_s``
  and at close, with a profile record per bucket.
* The JAX tests of tests/test_tracing.py: the JSONL sink, its no-op
  without a path, the annotation helpers.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from fast_tffm_tpu import profiling as jax_profiling
from fast_tffm_tpu.telemetry import RunMonitor as JaxRunMonitor
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.prediction import predict
from fast_tffm_tpu_torch.profiling import (
    CostLedger,
    DataStatsCollector,
    StepProfiler,
    modeled_step_bytes,
    parse_profile_steps,
)
from fast_tffm_tpu_torch.serving import ServingEngine
from fast_tffm_tpu_torch.telemetry import ENVELOPE_FIELDS, SCHEMAS, RunMonitor
from fast_tffm_tpu_torch.training import train
from fast_tffm_tpu_torch.utils.prefetch import InputStats, InputStream, prefetch
from fast_tffm_tpu_torch.utils import tracing
from fast_tffm_tpu_torch.utils.tracing import MetricsLogger, WindowTracer, step_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = os.path.join(REPO, "data", "train.libsvm")  # 400 rows: 20 batches of 20
TEST = os.path.join(REPO, "data", "test.libsvm")
V, K, NNZ, B = 256, 8, 8, 20


def quiet(*_):
    pass


def _read(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _kinds(records, kind):
    return [r for r in records if r["kind"] == kind]


def _assert_schema(records):
    for r in records:
        assert all(f in r for f in ENVELOPE_FIELDS), r
        assert all(k in r for k in SCHEMAS[r["kind"]]), r


def _steady(records):
    return [r for r in _kinds(records, "compile") if not r["warmup"]]


# --- parse_profile_steps, modeled_step_bytes ------------------------------------------


@pytest.mark.parametrize("spec", ["", "2:6", "0:1", "6", "6:2", "-1:4", "a:b", "3:3", "1:2:3"])
def test_parse_profile_steps_matches_jax(spec):
    try:
        want = jax_profiling.parse_profile_steps(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_profile_steps(spec)
        assert str(got.value) == str(e)
        return
    assert parse_profile_steps(spec) == want


def test_profile_steps_config_check():
    with pytest.raises(ValueError, match="profile_steps"):
        Config(telemetry_profile_steps="9:1").validate()


@pytest.mark.parametrize("shape,row_dim,accum", [((2, 3), 5, 1), ((20, 8), 9, 9),
                                                 ((4, 16, 11), 9, 1)])
def test_modeled_step_bytes_matches_jax(shape, row_dim, accum):
    ids = np.random.default_rng(1).integers(0, 40, size=shape).astype(np.int32)
    assert modeled_step_bytes(ids, row_dim, accum) == jax_profiling.modeled_step_bytes(
        ids, row_dim, accum)


# --- the id statistics -------------------------------------------------------------------


class _Parsed:
    def __init__(self, ids):
        self.ids = ids


@pytest.mark.parametrize("dist", ["zipf", "uniform", "padded"])
def test_datastats_integers_match_jax(tmp_path, dist):
    rng = np.random.default_rng(7)
    vocab = 1 << 14
    if dist == "zipf":
        ids = np.minimum(rng.zipf(1.1, size=(9, 256, 16)) - 1, vocab - 1)
    elif dist == "uniform":
        ids = rng.integers(0, vocab, size=(9, 256, 16))
    else:  # padding slots (id 0) count, as the gather reads them
        ids = rng.integers(0, vocab, size=(9, 256, 16))
        ids[:, 100:] = 0
    ids = ids.astype(np.int32)
    mon, jmon = RunMonitor(str(tmp_path / "p.jsonl")), JaxRunMonitor(str(tmp_path / "j.jsonl"))
    col = DataStatsCollector(mon, vocab=vocab, row_dim=9, every_steps=2, heavy_hitter_k=16)
    jcol = jax_profiling.DataStatsCollector(jmon, vocab=vocab, row_dim=9, every_steps=2,
                                            heavy_hitter_k=16)
    for i in range(9):
        col.note(i + 1, batch=_Parsed(torch.from_numpy(ids[i])))
        jcol.note(i + 1, parsed=_Parsed(ids[i]))
    assert col.summary() == jcol.summary()
    mon.close()
    jmon.close()
    got, want = _kinds(_read(tmp_path / "p.jsonl"), "datastats"), _kinds(
        _read(tmp_path / "j.jsonl"), "datastats")
    assert len(got) == len(want) == 4
    keys = ("step", "window_steps", "ids", "unique", "dedup_ratio", "rows_seen",
            "rows_seen_frac", "hh_k", "hh_topk_mass", "hh_top_counts", "gather_bytes",
            "dedup_gather_bytes", "projected_gather_savings_frac")
    for g, w in zip(got, want):
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
    _assert_schema(got)


def test_datastats_collector_skews_toward_heavy_hitters(tmp_path):
    mon = RunMonitor(str(tmp_path / "ds.jsonl"))
    rng = np.random.default_rng(0)
    zipf = np.minimum(rng.zipf(1.1, size=(8, 256, 16)) - 1, (1 << 14) - 1)
    uni = rng.integers(0, 1 << 14, size=(8, 256, 16))
    summaries = []
    for data in (zipf, uni):
        col = DataStatsCollector(mon, vocab=1 << 14, row_dim=8, every_steps=1)
        for i in range(8):
            col.note(i + 1, batch=_Parsed(torch.from_numpy(data[i].astype(np.int32))))
        summaries.append(col.summary())
    mon.close()
    assert summaries[0]["datastats_dedup_ratio"] < summaries[1]["datastats_dedup_ratio"]
    assert summaries[0]["datastats_hh_topk_mass"] > summaries[1]["datastats_hh_topk_mass"]
    assert len(_kinds(_read(tmp_path / "ds.jsonl"), "datastats")) == 14  # armed, then 7 each


# --- instrumented runs ---------------------------------------------------------------------


def _cfg(tmp_path, name="m.ckpt", **kw):
    for src in (TRAIN, TEST):
        if not (tmp_path / os.path.basename(src)).exists():
            shutil.copy(src, tmp_path)
    base = dict(
        model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
        model_file=str(tmp_path / name), train_files=(str(tmp_path / "train.libsvm"),),
        epoch_num=2, batch_size=B, learning_rate=0.05, log_every=4, thread_num=2,
        metrics_path=str(tmp_path / (name + ".jsonl")),
    )
    base.update(kw)
    return Config(**base).validate()


def test_streamed_profile_and_datastats(tmp_path):
    cfg = _cfg(tmp_path, telemetry_datastats_every_steps=3)
    train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    _assert_schema(records)
    assert _steady(records) == []
    (prof,) = [r for r in _kinds(records, "profile") if r["program"] == "train_step"]
    assert prof["flops"] is None and prof["bytes_accessed"] is None  # not measured
    assert prof["examples"] == B and prof["modeled_hbm_bytes"] > 0
    ds = _kinds(records, "datastats")
    assert ds
    for r in ds:
        assert r["ids"] == B * NNZ and 0 < r["unique"] <= r["ids"]
        assert r["dedup_ratio"] == pytest.approx(r["unique"] / r["ids"], abs=1e-3)
        assert 0 < r["rows_seen"] <= V and 0.0 < r["hh_topk_mass"] <= 1.0
    assert [r["rows_seen"] for r in ds] == sorted(r["rows_seen"] for r in ds)
    (summary,) = _kinds(records, "summary")
    assert summary["datastats_samples"] == len(ds) and summary["profile_programs"] == 1


def test_device_cache_profile_and_datastats(tmp_path):
    cfg = _cfg(tmp_path, device_cache=True, binary_cache=True, steps_per_call=4,
               telemetry_datastats_every_steps=2)
    train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    _assert_schema(records)
    assert _steady(records) == []
    (prof,) = [r for r in _kinds(records, "profile") if r["program"] == "train_step"]
    assert prof["examples"] == B * 4 and prof["modeled_hbm_bytes"] > 0
    ds = _kinds(records, "datastats")
    assert ds and ds[0]["ids"] == B * 4 * NNZ  # a call's [K·B, N] resident ids


def test_predict_records(tmp_path):
    cfg = _cfg(tmp_path, epoch_num=1, predict_files=(str(tmp_path / "test.libsvm"),),
               score_path=str(tmp_path / "s.txt"))
    train(cfg, log=quiet, device="cpu")
    pcfg = _cfg(tmp_path, "m.ckpt", predict_files=(str(tmp_path / "test.libsvm"),),
                score_path=str(tmp_path / "s.txt"),
                metrics_path=str(tmp_path / "predict.jsonl"))
    predict(pcfg, log=quiet, device="cpu")
    records = _read(pcfg.metrics_path)
    _assert_schema(records)
    (prof,) = [r for r in _kinds(records, "profile") if r["program"] == "predict_step"]
    assert prof["examples"] == B
    (rec,) = _kinds(records, "predict")
    assert rec["examples"] == sum(1 for _ in open(TEST)) and rec["examples_per_sec"] > 0
    (inp,) = _kinds(records, "input")
    assert inp["input_examples"] >= rec["examples"]
    assert _kinds(records, "summary")[0]["steady_compiles"] == 0


def test_profile_steps_trace_window(tmp_path):
    cfg = _cfg(tmp_path, telemetry_profile_steps="2:6")
    train(cfg, log=quiet, device="cpu")
    records = _read(cfg.metrics_path)
    events = [r for r in _kinds(records, "profile") if r["program"] == "trace"]
    assert [e["event"] for e in events] == ["trace_start", "trace_stop"]
    assert events[0]["step"] >= 2 and events[1]["step"] >= 6
    trace_dir = cfg.model_file + ".profile"
    assert events[0]["trace_dir"] == trace_dir
    path = events[1]["trace_path"]
    assert os.path.dirname(path) == trace_dir and os.path.getsize(path) > 0
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    assert any(n.startswith("train#") for n in names)  # the step annotations
    assert _steady(records) == []


def test_step_profiler_closes_a_window_past_the_run(tmp_path):
    mon = RunMonitor(str(tmp_path / "m.jsonl"))
    prof = StepProfiler("1:100", str(tmp_path / "p"), monitor=mon)
    for step in (1, 2, 3):
        with step_trace("train", step):
            torch.ones(4).sum()
        prof.on_step(step)
    prof.close(3)
    mon.close()
    events = [r["event"] for r in _kinds(_read(tmp_path / "m.jsonl"), "profile")]
    assert events == ["trace_start", "trace_stop"] and os.path.isfile(prof.path)


def test_trace_dir_writes_a_window(tmp_path):
    cfg = _cfg(tmp_path, trace_dir=str(tmp_path / "trace"), trace_steps=4, epoch_num=1)
    train(cfg, log=quiet, device="cpu")
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("window.")


def test_cost_ledger_records_each_program_once(tmp_path):
    mon = RunMonitor(str(tmp_path / "m.jsonl"))
    ledger = CostLedger(mon)
    ledger.stage("train_step", examples=20, modeled_bytes=100)
    ledger.stage("train_step", examples=99)  # staged already
    ledger.flush(1)
    ledger.stage("train_step", examples=99)  # recorded already
    ledger.stage("train_graph_k8", examples=160)
    ledger.flush(8)
    mon.close()
    recs = _kinds(_read(tmp_path / "m.jsonl"), "profile")
    assert [(r["program"], r["step"], r["examples"]) for r in recs] == [
        ("train_step", 1, 20), ("train_graph_k8", 8, 160)]
    assert ledger.summary() == {"profile_programs": 2}


# --- the input stats --------------------------------------------------------------------


def test_input_stream_stats_and_probes():
    class P:
        batch_size = 20

    stats = InputStats()
    items = [(P(), None), ([P(), P()], None), (P(), None)]
    stream = InputStream(prefetch(stats.timed(items), depth=2, stats=stats), stats)
    assert stream.producer_alive() is None  # the producer starts at the first pull
    it = iter(stream)
    first = next(it)
    assert stream.producer_alive() is not None and stream.queue_depth() is not None
    assert len([first, *it]) == 3
    rec = stats.drain()
    assert (rec["input_items"], rec["input_steps"], rec["input_examples"]) == (3, 4, 80)
    assert rec["h2d_ms"] is None and rec["prefetch_queue_depth"] is not None
    assert stats.drain() == {}
    assert all(k in rec for k in SCHEMAS["input"])


# --- serving ----------------------------------------------------------------------------


def _serve_cfg(tmp_path, **kw):
    model = tmp_path / "m.ckpt"
    rng = np.random.default_rng(0)
    with open(model, "wb") as f:
        np.savez(f, table=rng.uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32),
                 step=np.int64(3))
    return Config(model="fm", order=3, factor_num=K, vocabulary_size=V, max_nnz=NNZ,
                  model_file=str(model), serve_buckets=(1, 4, 16), serve_flush_deadline_ms=1.0,
                  metrics_path=str(tmp_path / "serve.jsonl"), **kw).validate()


def test_serving_writes_kind_serving_at_its_cadence_and_close(tmp_path):
    cfg = _serve_cfg(tmp_path, serve_metrics_every_s=1e-6)
    eng = ServingEngine(cfg, log=quiet, device="cpu")
    futures = [eng.submit_line(f"1 {i}:1.0 {i + 1}:0.5") for i in range(12)]
    for fut in futures:
        fut.result(timeout=10)
    run_id = eng.run_id
    eng.close()
    records = _read(cfg.metrics_path)
    _assert_schema(records)
    assert {r["run_id"] for r in records} == {run_id}
    serving = _kinds(records, "serving")
    assert len(serving) >= 2  # at least one at the cadence, one at close
    assert serving[-1]["requests"] == serving[-1]["rows"] == 12
    assert [r["program"] for r in _kinds(records, "profile")] == [
        "serve_score_b1", "serve_score_b4", "serve_score_b16"]
    (summary,) = _kinds(records, "summary")
    assert summary["steady_compiles"] == 0
    assert all(r["warmup"] for r in _kinds(records, "compile"))


def test_serving_cadence_zero_writes_only_the_close_record(tmp_path):
    cfg = _serve_cfg(tmp_path, serve_metrics_every_s=0.0)
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        eng.submit_line("1 3:1.0").result(timeout=10)
        assert eng.health()["steady_compiles"] == 0
    assert len(_kinds(_read(cfg.metrics_path), "serving")) == 1


# --- the tracing helpers (tests/test_tracing.py) ------------------------------------------


def test_metrics_logger_writes_jsonl(tmp_path):
    p = tmp_path / "m.jsonl"
    with MetricsLogger(str(p)) as m:
        m.log(step=1, loss=0.5)
        m.log(step=2, loss=float("inf"), validation_auc=0.7)
    rows = _read(p)
    assert [r["step"] for r in rows] == [1, 2]
    assert rows[1]["validation_auc"] == 0.7 and rows[1]["loss"] == "inf"
    assert all("ts" in r for r in rows)


def test_metrics_logger_noop_without_path(tmp_path):
    with MetricsLogger("") as m:
        m.log(step=1)
    assert not m.active


def test_step_trace_and_maybe_trace(tmp_path):
    """``step_trace`` is the span ``name#step``: nothing while spans are
    off, a host range while they are on; the window tracer's trace holds
    the ones inside its window."""
    def annotations(prof):
        return {e.name for e in prof.events() if e.name.startswith("train#")}

    with torch.profiler.profile() as off:
        with step_trace("train", 3):
            torch.ones(3).sum()
    tracing.spans_on(True)
    try:
        with torch.profiler.profile() as on:
            with step_trace("train", 4):
                torch.ones(3).sum()
    finally:
        tracing.spans_on(False)
    assert annotations(off) == set() and annotations(on) == {"train#4"}
    tracer = WindowTracer(str(tmp_path / "w"), skip=1, count=2)
    for step in range(5):
        tracer.on_step()
        with step_trace("train", step):
            torch.ones(3).sum()
    tracer.close()
    assert tracer.path and os.path.isfile(tracer.path) and not tracing.spans_enabled()
    names = {e.get("name", "") for e in json.load(open(tracer.path))["traceEvents"]}
    assert {"train#1", "train#2"} <= names and "train#0" not in names
