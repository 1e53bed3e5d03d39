"""Port: the serving path against the JAX package on the CPU.

One npz checkpoint, written by the JAX package's ``save_checkpoint``, is
restored by both packages; the same libsvm lines go through the JAX
``ServingEngine`` / ``serve_lines`` and the port's with ``device="cpu"`` at
order 3 and baseline5's width (k = 8, max_nnz = 11) over a small
vocabulary.  Scores must agree to atol 1e-6.  The rest pins the engine
behaviour the port copied: bucket padding, flush triggers, overload,
deadlines, cancellation, close, and the checkpoints it refuses.
"""

import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_tffm_tpu.checkpoint import checkpoint_signature as jax_checkpoint_signature
from fast_tffm_tpu.checkpoint import save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.prediction import load_scoring_state as jax_load_scoring_state
from fast_tffm_tpu.prediction import make_score_fn as jax_make_score_fn
from fast_tffm_tpu.serving import AdmissionQueue as JaxAdmissionQueue
from fast_tffm_tpu.serving import BucketLadder as JaxBucketLadder
from fast_tffm_tpu.serving import LatencyHistogram as JaxLatencyHistogram
from fast_tffm_tpu.serving import ServingEngine as JaxServingEngine
from fast_tffm_tpu.serving import serve_lines as jax_serve_lines
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.checkpoint import checkpoint_signature, restore_checkpoint
from fast_tffm_tpu_torch.checkpoint import save_checkpoint as port_save_checkpoint
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.libsvm import parse_lines
from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn
from fast_tffm_tpu_torch.serving import (
    AdmissionQueue,
    BucketLadder,
    DeadlineExceeded,
    LatencyHistogram,
    OverloadError,
    ServingEngine,
    serve_lines,
)

V = 256
NNZ = 11
K = 8
ORDER = 3
ATOL = 1e-6
CPU = torch.device("cpu")


def quiet(*_):
    pass


def _lines(rng, n, nnz_lo=1, nnz_hi=NNZ):
    """Mixed-width libsvm lines — every request width in [lo, hi]."""
    out = []
    for _ in range(n):
        k = int(rng.integers(nnz_lo, nnz_hi + 1))
        ids = rng.choice(V, size=k, replace=False)
        vals = np.round(rng.uniform(0.05, 1.0, size=k), 4)
        out.append(f"{int(rng.integers(0, 2))} " + " ".join(f"{i}:{v}" for i, v in zip(ids, vals)))
    return out


def _cfgs(tmp_path, **kw):
    """The same settings as a JAX Config and a port Config."""
    kw.setdefault("model", "fm")
    kw.setdefault("order", ORDER)
    kw.setdefault("factor_num", K)
    kw.setdefault("vocabulary_size", V)
    kw.setdefault("max_nnz", NNZ)
    kw.setdefault("model_file", str(tmp_path / "m.ckpt"))
    kw.setdefault("serve_buckets", (1, 4, 16))
    kw.setdefault("serve_flush_deadline_ms", 20.0)
    jcfg = JaxConfig(telemetry_profile_costs=False, **kw).validate()
    return jcfg, Config(**kw).validate()


def _jax_checkpoint(jcfg, seed=0, step=3):
    """A JAX state with a random table (factors large enough that the
    order-3 terms matter), saved by the JAX package as npz."""
    rng = np.random.default_rng(seed)
    model = jax_build_model(jcfg)
    state = jax_init_state(model, jax.random.key(0), jcfg.init_accumulator_value)
    table = rng.uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    state = state._replace(table=jnp.asarray(table), step=state.step + step)
    save_checkpoint(jcfg.model_file, state)
    return state


def _npz(path, seed=0, step=3):
    """A checkpoint in _save_npz's member layout, written with numpy alone."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.3, 0.3, size=(V, 1 + K)).astype(np.float32)
    with open(path, "wb") as f:
        np.savez(f, table=table, table_accum=np.full((V, 1), 0.1, np.float32), step=np.int64(step))
    return table


def _engine(cfg, **kw):
    return ServingEngine(cfg, log=quiet, device="cpu", **kw)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_npz_restore_is_bitwise(tmp_path):
    jcfg, cfg = _cfgs(tmp_path)
    jstate = _jax_checkpoint(jcfg, step=5)
    state = restore_checkpoint(cfg.model_file, CPU)
    np.testing.assert_array_equal(state.table.numpy(), np.asarray(jstate.table))
    assert state.table.dtype == torch.float32
    assert state.step == int(jstate.step) == 5
    assert state.dense == []
    # load_scoring_state goes through the same restore.
    _, scoring = load_scoring_state(cfg, quiet, device="cpu")
    np.testing.assert_array_equal(scoring.table.numpy(), np.asarray(jstate.table))


def test_checkpoint_signature_matches_jax(tmp_path):
    jcfg, cfg = _cfgs(tmp_path)
    assert checkpoint_signature(cfg.model_file) is None
    _jax_checkpoint(jcfg)
    sig = checkpoint_signature(cfg.model_file)
    assert sig == jax_checkpoint_signature(jcfg.model_file)
    assert sig[0] == 3


def test_refuses_tiered_delta_and_orbax_checkpoints(tmp_path):
    path = str(tmp_path / "t.ckpt")
    with open(path, "wb") as f:
        np.savez(f, table=np.zeros((4, 9), np.float32), step=np.int64(1),
                 tier_hot_ids=np.arange(4))
    with pytest.raises(ValueError, match="TIERED"):
        restore_checkpoint(path, CPU)
    base = str(tmp_path / "d.ckpt")
    _npz(base)
    restore_checkpoint(base, CPU)  # loads alone
    open(base + ".delta-0001.npz", "wb").close()
    with pytest.raises(ValueError, match="delta"):
        restore_checkpoint(base, CPU)
    # An orbax directory restores; one with no tree yet (a save caught
    # mid-write, an empty directory) is refused, naming what is missing.
    os.makedirs(tmp_path / "o.orbax")
    with pytest.raises(ValueError, match="not an orbax checkpoint directory"):
        restore_checkpoint(str(tmp_path / "o.orbax"), CPU)
    _npz(str(tmp_path / "e.ckpt"))
    state = restore_checkpoint(str(tmp_path / "e.ckpt"), CPU, accum_width=1)
    port_save_checkpoint(str(tmp_path / "o.orbax"), state)
    back = restore_checkpoint(str(tmp_path / "o.orbax"), CPU)
    assert torch.equal(back.table, state.table) and back.step == state.step == 3


def test_refuses_torn_checkpoint(tmp_path):
    path = str(tmp_path / "torn.ckpt")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 not a whole zip")
    with pytest.raises(ValueError, match="unreadable"):
        restore_checkpoint(path, CPU)


def test_table_narrower_than_config_is_refused(tmp_path):
    _, cfg = _cfgs(tmp_path, factor_num=4)
    _npz(cfg.model_file)  # rows of 1 + 8
    with pytest.raises(ValueError, match="table"):
        load_scoring_state(cfg, quiet, device="cpu")


# ---------------------------------------------------------------------------
# scores against the JAX package
# ---------------------------------------------------------------------------


def test_engine_scores_match_jax_engine(tmp_path):
    jcfg, cfg = _cfgs(tmp_path)
    _jax_checkpoint(jcfg)
    lines = _lines(np.random.default_rng(1), 40)
    with JaxServingEngine(jcfg, log=quiet) as je:
        want = [f.result(timeout=60) for f in [je.submit_line(x) for x in lines]]
        want_parsed = je.submit(ids=[3, 9, 40], vals=[0.5, 1.25, 0.75]).result(timeout=60)
    with _engine(cfg) as pe:
        got = [f.result(timeout=60) for f in [pe.submit_line(x) for x in lines]]
        got_parsed = pe.submit(ids=[3, 9, 40], vals=[0.5, 1.25, 0.75]).result(timeout=60)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_parsed, want_parsed, rtol=0, atol=ATOL)


def test_serve_lines_matches_jax(tmp_path):
    jcfg, cfg = _cfgs(tmp_path)
    _jax_checkpoint(jcfg)
    lines = _lines(np.random.default_rng(2), 37) + [""]  # blank lines are skipped
    jout, pout = io.StringIO(), io.StringIO()
    assert jax_serve_lines(jcfg, lines, out=jout, log=quiet) == 0
    snap = serve_lines(cfg, lines, out=pout, log=quiet, device="cpu")
    want = np.array(jout.getvalue().split(), np.float64)
    got = np.array(pout.getvalue().split(), np.float64)
    assert got.shape == want.shape == (37,)
    # Both print %.6f: the values agree to atol 1e-6, plus 1e-9 for the
    # float64 difference of two neighbouring printed decimals.
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL + 1e-9)
    assert snap["rows"] == 37 and snap["requests"] == 37


def test_bucket_padding_at_every_boundary(tmp_path):
    """bucket_for at n, n±1 around every rung; assemble pads with weight-0
    all-zero rows up to exactly the chosen bucket, placing the same arrays
    as the JAX package's ladder."""
    jcfg, cfg = _cfgs(tmp_path)
    _jax_checkpoint(jcfg)
    model, state = load_scoring_state(cfg, quiet, device="cpu")
    ladder = BucketLadder(make_score_fn(cfg, state, NNZ, model=model), (1, 4, 16), device=CPU)
    jmodel, jstate = jax_load_scoring_state(jcfg, log=quiet)
    jladder = JaxBucketLadder(jax_make_score_fn(jcfg, jstate, NNZ, model=jmodel), (1, 4, 16))
    assert [ladder.bucket_for(n) for n in (1, 2, 3, 4, 5, 15, 16)] == [1, 4, 4, 4, 16, 16, 16]
    for bad in (0, 17):
        with pytest.raises(ValueError):
            ladder.bucket_for(bad)
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 5, 16):
        parsed = parse_lines(_lines(rng, n), vocabulary_size=V, max_nnz=NNZ)
        rows = [(parsed.ids[i].astype(np.int32), parsed.vals[i], parsed.fields[i]) for i in range(n)]
        batch, bucket = ladder.assemble(rows)
        jbatch, jbucket = jladder.assemble(rows)
        assert bucket == jbucket == ladder.bucket_for(n)
        assert batch.ids.shape == (bucket, NNZ) and batch.ids.dtype == torch.int32
        assert batch.fields.shape == (bucket, 0)
        w = batch.weights.numpy()
        np.testing.assert_array_equal(w[:n], 1.0)
        np.testing.assert_array_equal(w[n:], 0.0)
        np.testing.assert_array_equal(batch.vals.numpy()[n:], 0.0)
        for name in ("labels", "ids", "vals", "weights"):
            np.testing.assert_array_equal(
                getattr(batch, name).numpy(), np.asarray(getattr(jbatch, name)), err_msg=name
            )
        # Padding rows cost their bucket but score sigmoid(0).
        np.testing.assert_allclose(ladder.score(state, batch).numpy()[n:], 0.5)


def test_assemble_parts_coalesces_into_one_bucket(tmp_path):
    _, cfg = _cfgs(tmp_path)
    _npz(cfg.model_file)
    model, state = load_scoring_state(cfg, quiet, device="cpu")
    ladder = BucketLadder(make_score_fn(cfg, state, NNZ, model=model), (1, 4, 16), device=CPU)
    rng = np.random.default_rng(4)
    parsed = parse_lines(_lines(rng, 6), vocabulary_size=V, max_nnz=NNZ)
    ids, vals = parsed.ids.astype(np.int32), parsed.vals
    batch, bucket = ladder.assemble_parts([(ids[:2], vals[:2], None), (ids[2:], vals[2:], None)])
    rows = [(ids[i], vals[i], parsed.fields[i]) for i in range(6)]
    ref, ref_bucket = ladder.assemble(rows)
    assert bucket == ref_bucket == 16
    for name in ("ids", "vals", "weights"):
        np.testing.assert_array_equal(getattr(batch, name).numpy(), getattr(ref, name).numpy())


# ---------------------------------------------------------------------------
# engine behaviour (port only)
# ---------------------------------------------------------------------------


def test_submit_parsed_matches_submit_line_and_validates(tmp_path):
    _, cfg = _cfgs(tmp_path)
    _npz(cfg.model_file)
    with _engine(cfg) as eng:
        a = eng.submit_line("1 3:0.5 9:1.25 40:0.75").result(timeout=10)
        b = eng.submit(ids=[3, 9, 40], vals=[0.5, 1.25, 0.75]).result(timeout=10)
        with pytest.raises(ValueError):
            eng.submit(ids=list(range(NNZ + 1)), vals=[1.0] * (NNZ + 1))
        with pytest.raises(ValueError):
            eng.submit(ids=[V], vals=[1.0])
        with pytest.raises(ValueError):
            eng.submit_line("1 " + " ".join(f"{i}:1" for i in range(NNZ + 1)))
        health = eng.health()
    assert a == b
    assert health["ok"] and health["step"] == 3 and health["queue_depth"] == 0


def test_deadline_flush_fires_before_full_batch(tmp_path):
    _, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=30.0)
    _npz(cfg.model_file)
    with _engine(cfg) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit_line(x) for x in _lines(np.random.default_rng(1), 3)]
        for f in futs:
            f.result(timeout=10)
        dt = time.perf_counter() - t0
        snap = eng.metrics_snapshot()
    assert snap["flushes_deadline"] >= 1 and snap["rows"] == 3
    assert 0.025 <= dt < 5.0


def test_full_batch_flushes_without_waiting_for_deadline(tmp_path):
    _, cfg = _cfgs(
        tmp_path, serve_flush_deadline_ms=10_000.0, serve_buckets=(1, 4), serve_max_batch=4
    )
    _npz(cfg.model_file)
    with _engine(cfg) as eng:
        t0 = time.perf_counter()
        futs = [eng.submit_line(x) for x in _lines(np.random.default_rng(2), 4)]
        for f in futs:
            f.result(timeout=8)
        dt = time.perf_counter() - t0
        snap = eng.metrics_snapshot()
    assert dt < 5.0
    assert snap["flushes_full"] >= 1 and snap["batch_occupancy"] == 1.0


def test_cancelled_future_does_not_kill_collector(tmp_path):
    _, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=10_000.0)
    _npz(cfg.model_file)
    eng = _engine(cfg)
    f1 = eng.submit_line("1 3:1.0 9:1.0")
    assert f1.cancel()
    f2 = eng.submit_line("1 3:1.0 9:1.0")
    eng.close()  # flushes the pending pair: f1 dropped at claim, f2 scored
    assert 0.0 <= f2.result(timeout=1) <= 1.0
    assert eng.metrics_snapshot()["rows"] == 1


def test_close_flushes_pending_and_refuses_new_work(tmp_path):
    _, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=10_000.0)
    _npz(cfg.model_file)
    eng = _engine(cfg)
    futs = [eng.submit_line(x) for x in _lines(np.random.default_rng(4), 3)]
    eng.close()
    for f in futs:
        assert 0.0 <= f.result(timeout=1) <= 1.0
    from fast_tffm_tpu_torch.serving import EngineClosed

    with pytest.raises(EngineClosed):
        eng.submit_line("1 3:1")
    assert not eng.health()["ok"]


def _slow_score(eng, delay):
    orig = eng._ladder._score

    def slow(state, batch):
        time.sleep(delay)
        return orig(state, batch)

    eng._ladder._score = slow


@pytest.mark.parametrize("policy", ["reject", "block"])
def test_overload_policy(tmp_path, policy):
    _, cfg = _cfgs(
        tmp_path, serve_queue_size=2, serve_overload=policy, serve_buckets=(1,),
        serve_flush_deadline_ms=0.0,
    )
    _npz(cfg.model_file)
    with _engine(cfg) as eng:
        _slow_score(eng, 0.005 if policy == "reject" else 0.002)
        futs, rejected = [], 0
        for x in _lines(np.random.default_rng(5), 40, nnz_lo=1, nnz_hi=1):
            try:
                futs.append(eng.submit_line(x))
            except OverloadError:
                rejected += 1
        for f in futs:  # every accepted request still gets its score
            assert 0.0 <= f.result(timeout=30) <= 1.0
        snap = eng.metrics_snapshot()
    if policy == "reject":
        assert rejected > 0
    else:
        assert rejected == 0
    assert snap["rejected"] == rejected and snap["requests"] == 40
    assert snap["rows"] == 40 - rejected


def test_expired_requests_are_shed_before_padding(tmp_path):
    _, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=10_000.0, serve_deadline_ms=1.0)
    _npz(cfg.model_file)
    eng = _engine(cfg)
    late = eng.submit_line("1 3:1", klass="std")
    time.sleep(0.01)  # past its 1 ms budget while the 10 s flush timer waits
    fine = eng.submit_line("1 3:1", deadline_ms=0)  # 0 disables the default
    eng.close()
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=1)
    assert 0.0 <= fine.result(timeout=1) <= 1.0
    snap = eng.metrics_snapshot()
    assert snap["deadline_drops"] == 1 and snap["deadline_drops_by_class"] == {"std": 1}
    assert snap["rows"] == 1


def test_hot_reload_is_refused_until_ported(tmp_path):
    """Hot reload is ported; what stays refused, as in the JAX engine, is
    reloading into an injected fused-packed state (a reload restores
    plain-packed, which the fused gather cannot read)."""
    from fast_tffm_tpu_torch.trainer import pack_state

    _, cfg = _cfgs(tmp_path, serve_reload_interval_s=1.0, table_layout="packed",
                   adagrad_accumulator="fused")
    _npz(cfg.model_file)
    fused = pack_state(restore_checkpoint(cfg.model_file, CPU, accum_width=1), fused=True)
    with pytest.raises(ValueError, match="reload"):
        _engine(cfg, state=fused)
    _engine(cfg).close()  # a restored (plain-packed) state reloads


def test_serve_writes_its_records_to_metrics_path(tmp_path):
    """serve writes the JAX engine's records to metrics_path (kind=serving
    at close, compile, profile per bucket, mem, summary) and logs no note
    that it ignores the key."""
    _, cfg = _cfgs(tmp_path, metrics_path=str(tmp_path / "m.jsonl"))
    _npz(cfg.model_file)
    log = []
    out = io.StringIO()
    serve_lines(cfg, _lines(np.random.default_rng(3), 5), out=out, log=log.append, device="cpu")
    assert not [m for m in log if m.startswith("note: metrics_path")]
    assert len(out.getvalue().split()) == 5
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    (serving,) = [r for r in recs if r["kind"] == "serving"]
    assert serving["requests"] == 5 and serving["rows"] == 5
    assert {r["program"] for r in recs if r["kind"] == "profile"} == {
        f"serve_score_b{b}" for b in cfg.serve_buckets}
    (summary,) = [r for r in recs if r["kind"] == "summary"]
    assert summary["steady_compiles"] == 0


def test_latency_histogram_matches_jax():
    rng = np.random.default_rng(6)
    samples = np.exp(rng.normal(-6, 1.5, size=500))
    got, want = LatencyHistogram(), JaxLatencyHistogram()
    assert got.snapshot() == want.snapshot() == {"count": 0}
    for s in samples:
        got.add(float(s))
        want.add(float(s))
    got.add_many(0.003, 7)
    want.add_many(0.003, 7)
    assert got.snapshot() == want.snapshot()


def test_admission_queue_matches_jax():
    """The same puts (with tiered eviction) and gets on both queues."""
    import queue

    ours, theirs = AdmissionQueue(3), JaxAdmissionQueue(3)
    ops = [("put", "a", 0), ("put", "b", 1), ("put", "c", 0), ("put", "d", 2),
           ("put", "e", 0), ("get",), ("put", "f", 1), ("put", "g", 1), ("get",), ("get",)]
    for op in ops:
        results = []
        for q in (ours, theirs):
            try:
                results.append(q.put_nowait(op[1], tier=op[2]) if op[0] == "put" else q.get_nowait())
            except (queue.Full, queue.Empty) as e:
                results.append(type(e))
        assert results[0] == results[1], op
        assert ours.qsize() == theirs.qsize()
