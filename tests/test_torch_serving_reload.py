"""Port: the serving engine's hot reload and block submission, against the
JAX package on the CPU.

Checkpoints are written by the JAX package (``save_checkpoint`` and
``save_delta``); the port's engine (``device="cpu"``) reloads them between
flushes.  After every reload its scores must equal, bitwise, a fresh port
engine restored from the same chain head, and the JAX engine after the same
reloads within atol 1e-6, on the rows and the plain-packed layout.  The
rest pins the failure discipline (a torn file counted and survived, the
give-up after ``serve_reload_max_retries`` and its reset on a new write),
the serialised ``reload_once``, the live table never written by a delta,
and ``submit_block``.
"""

import json
import os
import struct
import threading
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_tffm_tpu.checkpoint import checkpoint_save_id as jax_checkpoint_save_id
from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.checkpoint import save_delta as jax_save_delta
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.ops.packed_table import pack_table as jax_pack_table
from fast_tffm_tpu.ops.packed_table import scatter_logical_rows as jax_scatter_logical_rows
from fast_tffm_tpu.serving import ServingEngine as JaxServingEngine
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.libsvm import parse_lines
from fast_tffm_tpu_torch.ops.packed_table import pack_table, scatter_logical_rows
from fast_tffm_tpu_torch.serving import ServingEngine
from fast_tffm_tpu_torch.serving.protocol import FRAME_STATUS_CODES

import torch

V = 300
NNZ = 11
K = 8
ATOL = 1e-6
PROBE = 16  # probe rows per block: one bucket-16 flush in every engine


def quiet(*_):
    pass


def _cfgs(tmp_path, **kw):
    kw.setdefault("model", "fm")
    kw.setdefault("order", 3)
    kw.setdefault("factor_num", K)
    kw.setdefault("vocabulary_size", V)
    kw.setdefault("max_nnz", NNZ)
    kw.setdefault("model_file", str(tmp_path / "m.ckpt"))
    kw.setdefault("serve_buckets", (1, 4, 16))
    kw.setdefault("serve_flush_deadline_ms", 2.0)
    jcfg = JaxConfig(telemetry_profile_costs=False, **kw).validate()
    return jcfg, Config(telemetry_profile_costs=False, **kw).validate()


def _jax_base(jcfg, seed, step):
    """A seeded [V, 1+K] table at ``step``, saved by the JAX package."""
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1)
    table = np.random.default_rng(seed).uniform(-0.3, 0.3, (V, 1 + K)).astype(np.float32)
    jax_save_checkpoint(jcfg.model_file, state._replace(table=jnp.asarray(table),
                                                        step=state.step + step), "npz")
    return jax_checkpoint_save_id(jcfg.model_file)


def _jax_delta(path, seq, parent, seed, step, rows=None):
    """Delta ``seq`` of the chain at ``path``, written by the JAX package."""
    rng = np.random.default_rng(100 + seed)
    idx = np.sort(rng.choice(V, size=40, replace=False)) if rows is None else np.asarray(rows)
    _, sid, _ = jax_save_delta(
        path, seq, idx=idx,
        table_rows=rng.uniform(-0.4, 0.4, (idx.size, 1 + K)).astype(np.float32),
        accum_rows=np.full((idx.size, 1 + K), 0.2, np.float32),
        dense_leaves=[], dense_accum_leaves=[], step=np.int32(step), parent_sig=parent,
    )
    return sid


def _probe(seed=5, n=PROBE):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(n, NNZ)).astype(np.int32)
    vals = rng.uniform(0.05, 1.0, size=(n, NNZ)).astype(np.float32)
    return ids, vals


def _scores(engine, probe):
    st, sc = engine.submit_block(*probe).result(timeout=30)
    assert not st.any(), st
    return np.asarray(sc)


def _fresh(cfg, probe):
    """A fresh port engine restored from what model_file holds now."""
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        return _scores(eng, probe)


def _wait_step(engine, step, probe, timeout=20.0):
    """Flush probes until the engine serves ``step`` (swaps happen at a
    flush); returns the scores of the first flush on it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sc = _scores(engine, probe)
        if engine.step == step:
            return _scores(engine, probe)
        time.sleep(0.01)
    raise AssertionError(f"engine still at step {engine.step}, waited for {step}")


def test_a_jax_npz_at_a_new_step_is_picked_up_mid_stream(tmp_path):
    """The watcher (reload_interval_s 0.05) swaps a JAX full save in while
    lines stream; every line is answered; after the swap the scores are a
    fresh engine's on the new file (bitwise) and the JAX engine's (1e-6)."""
    jcfg, cfg = _cfgs(tmp_path, serve_reload_interval_s=0.05,
                      metrics_path=str(tmp_path / "m.jsonl"))
    _jax_base(jcfg, seed=0, step=3)
    probe = _probe()
    eng = ServingEngine(cfg, log=quiet, device="cpu")
    try:
        before = _scores(eng, probe)
        lines = [f"1 {i % V}:0.5 {(7 * i) % V}:1.0" for i in range(400)]
        futs = [eng.submit_line(ln) for ln in lines[:200]]
        _jax_base(jcfg, seed=1, step=10)
        futs += [eng.submit_line(ln) for ln in lines[200:]]
        assert all(np.isfinite(f.result(timeout=30)) for f in futs)
        after = _wait_step(eng, 10, probe)
        snap = eng.metrics_snapshot()
    finally:
        eng.close()
    assert not np.array_equal(before, after)
    np.testing.assert_array_equal(after, _fresh(cfg, probe))
    jeng = JaxServingEngine(jcfg, log=quiet)
    try:
        want = np.asarray(jeng.submit_block(*probe).result(timeout=60)[1])
    finally:
        jeng.close()
    np.testing.assert_allclose(after, want, rtol=0, atol=ATOL)
    assert snap["reloads"] == 1 and snap["delta_reloads"] == 0
    assert snap["reload_failures"] == 0
    assert snap["freshness_applied_ms"]["count"] == 1
    assert snap["freshness_scored_ms"]["count"] == 1
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    (fresh,) = [r for r in recs if r["kind"] == "freshness"]
    assert fresh["publish_step"] == 10 and fresh["mode"] == "full"


@pytest.mark.parametrize("layout", ["rows", "packed"])
def test_a_jax_delta_chain_applies_in_place(tmp_path, layout):
    """Each delta of a JAX chain is staged by reload_once (staged_delta) and
    swapped in at the next flush: bitwise a fresh port engine on the same
    chain head, within 1e-6 of the JAX engine after the same reloads.  The
    table serving before the apply is never written."""
    jcfg, cfg = _cfgs(tmp_path, table_layout=layout)
    parent = _jax_base(jcfg, seed=0, step=2)
    probe = _probe()
    eng = ServingEngine(cfg, log=quiet, device="cpu")
    jeng = JaxServingEngine(jcfg, log=quiet)
    try:
        assert eng._state.layout == layout
        for seq, step in ((1, 5), (2, 9)):
            live = eng._state.table
            live_copy = live.clone()
            parent = _jax_delta(cfg.model_file, seq, parent, seed=seq, step=step)
            assert eng.reload_once()["status"] == "staged_delta"
            assert jeng.reload_once()["status"] == "staged_delta"
            got = _scores(eng, probe)  # this flush swaps the stage in
            assert eng.step == step
            assert torch.equal(live, live_copy)  # the apply wrote a copy
            assert eng._state.table is not live
            np.testing.assert_array_equal(got, _fresh(cfg, probe))
            want = np.asarray(jeng.submit_block(*probe).result(timeout=60)[1])
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
            assert eng.reload_once()["status"] == "noop"
        snap = eng.metrics_snapshot()
        assert snap["delta_reloads"] == 2 and snap["reloads"] == 0
        assert snap["freshness_applied_ms"]["count"] == 2
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scatter_logical_rows_matches_jax(seed):
    """The delta apply's packed scatter against the JAX function: D = 9
    (P = 14 rows to a tile row), ids sorted and unique, some sharing a tile
    row; the input table unchanged."""
    rng = np.random.default_rng(seed)
    v, d = 1000, 9
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = np.sort(rng.choice(v, size=[1, 37, 400][seed], replace=False)).astype(np.int32)
    rows = rng.normal(size=(ids.size, d)).astype(np.float32)
    packed = pack_table(torch.from_numpy(table))
    before = packed.clone()
    got = scatter_logical_rows(packed, torch.from_numpy(ids), torch.from_numpy(rows), d)
    want = jax_scatter_logical_rows(jax_pack_table(jnp.asarray(table)), jnp.asarray(ids),
                                    jnp.asarray(rows), d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(packed, before)


def _torn(path, src, member):
    """A copy of ``src`` at ``path`` whose ``member`` holds garbage bytes
    (a writer that died mid-file, or a bad disk): the step still reads, so
    the signature moves, and the restore or apply fails its CRC check."""
    data = bytearray(open(src, "rb").read())
    with zipfile.ZipFile(src) as z:
        off = z.getinfo(member).header_offset
    name_len, extra_len = struct.unpack_from("<HH", data, off + 26)
    start = off + 30 + name_len + extra_len
    for i in range(start + 128, start + 192):
        data[i] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


def test_a_torn_checkpoint_is_counted_and_survived(tmp_path):
    """A torn delta, then a torn full save: each reload fails, is counted,
    backs off, and leaves the serving state (and its scores) untouched; the
    complete delta written afterwards reloads."""
    jcfg, cfg = _cfgs(tmp_path)
    parent = _jax_base(jcfg, seed=0, step=2)
    probe = _probe()
    delta = cfg.model_file + ".delta-0001.npz"
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        base = _scores(eng, probe)
        good = str(tmp_path / "good.npz")
        _jax_delta(cfg.model_file, 1, parent, seed=1, step=4)
        os.replace(delta, good)
        _torn(delta, good, "table_rows.npy")
        assert eng.reload_once()["status"] == "failed"
        assert eng.reload_once()["status"] == "backoff"  # retried later, not now
        assert eng.metrics_snapshot()["reload_failures"] == 1
        np.testing.assert_array_equal(_scores(eng, probe), base)
        assert eng.step == 2
        os.replace(good, delta)  # the write completes: a new signature
        assert eng.reload_once()["status"] == "staged_delta"
        held = _scores(eng, probe)
        assert eng.step == 4
        np.testing.assert_array_equal(held, _fresh(cfg, probe))
        # A torn full save: the chain unlinked, the base rewritten badly.
        full = str(tmp_path / "full.npz")
        _jax_base(jcfg, seed=3, step=8)
        os.replace(cfg.model_file, full)
        _torn(cfg.model_file, full, "table.npy")
        assert eng.reload_once()["status"] == "failed"
        snap = eng.metrics_snapshot()
        assert snap["reload_failures"] == 2 and snap["delta_reloads"] == 1
        assert snap["reloads"] == 0
        np.testing.assert_array_equal(_scores(eng, probe), held)
        assert eng.step == 4


def test_giveup_after_reload_max_retries_and_reset_on_a_new_write(tmp_path):
    """serve_reload_max_retries = 2: the second failure on one signature
    gives up (reload_giveups 1, one kind=anomaly record) and later ticks
    back off for good; a NEW write resets the discipline and reloads."""
    jcfg, cfg = _cfgs(tmp_path, serve_reload_max_retries=2,
                      metrics_path=str(tmp_path / "m.jsonl"))
    parent = _jax_base(jcfg, seed=0, step=2)
    probe = _probe()
    eng = ServingEngine(cfg, log=quiet, device="cpu")
    try:
        good = str(tmp_path / "good.npz")
        _jax_delta(cfg.model_file, 1, parent, seed=1, step=6)
        os.replace(cfg.model_file + ".delta-0001.npz", good)
        _torn(cfg.model_file + ".delta-0001.npz", good, "table_rows.npy")
        statuses = [eng.reload_once()["status"]]
        deadline = time.monotonic() + 10
        while eng.metrics_snapshot()["reload_giveups"] == 0 and time.monotonic() < deadline:
            statuses.append(eng.reload_once()["status"])
            time.sleep(0.005)
        snap = eng.metrics_snapshot()
        assert snap["reload_giveups"] == 1 and snap["reload_failures"] == 2
        assert statuses[0] == "failed" and statuses[-1] == "failed"
        assert set(statuses[1:-1]) <= {"backoff"}
        time.sleep(0.1)  # past any backoff: still abandoned
        assert eng.reload_once()["status"] == "backoff"
        assert eng.step == 2
        os.replace(good, cfg.model_file + ".delta-0001.npz")  # a new write
        assert eng.reload_once()["status"] == "staged_delta"
        _scores(eng, probe)
        assert eng.step == 6
    finally:
        eng.close()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    (anomaly,) = [r for r in recs if r["kind"] == "anomaly"]
    assert anomaly["event"] == "reload_giveup" and anomaly["attempts"] == 2


def test_fused_packed_injected_state_refuses_hot_reload(tmp_path):
    """As in the JAX engine: an injected fused state cannot be reloaded
    into (a reload restores plain-packed); without the watcher it serves."""
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.trainer import pack_state

    jcfg, cfg = _cfgs(tmp_path, table_layout="packed", adagrad_accumulator="fused",
                      serve_reload_interval_s=0.5)
    from fast_tffm_tpu.trainer import pack_state as jax_pack_state

    jstate = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1, "row")
    jax_save_checkpoint(cfg.model_file, jstate, "npz")
    jfused = jax_pack_state(jstate, 0.1, fused=True)
    with pytest.raises(ValueError, match="reload"):
        JaxServingEngine(jcfg, log=quiet, state=jfused)
    restored = restore_checkpoint(cfg.model_file, torch.device("cpu"), accum_width=1)
    fused = pack_state(restored, 0.1, fused=True)
    with pytest.raises(ValueError, match="reload"):
        ServingEngine(cfg, log=quiet, device="cpu", state=fused)
    import dataclasses

    off = dataclasses.replace(cfg, serve_reload_interval_s=0.0)
    with ServingEngine(off, log=quiet, device="cpu", state=fused) as eng:
        assert np.isfinite(_scores(eng, _probe())).all()


def test_reload_once_is_serialised_under_concurrent_calls(tmp_path):
    """Router-driven reload_once from several threads while deltas land:
    ticks run one at a time, deltas apply in chain order, each exactly once,
    and the result is bitwise a fresh engine on the chain head."""
    jcfg, cfg = _cfgs(tmp_path)
    parent = _jax_base(jcfg, seed=0, step=1)
    probe = _probe()
    eng = ServingEngine(cfg, log=quiet, device="cpu")
    applied, inside, overlap = [], [0], []
    real = eng._apply_delta_state
    lock = threading.Lock()

    def traced(state, delta):
        with lock:
            inside[0] += 1
            overlap.append(inside[0])
        time.sleep(0.01)  # widen the window a racing tick would need
        out = real(state, delta)
        with lock:
            inside[0] -= 1
        applied.append(int(delta["step"]))
        return out

    eng._apply_delta_state = traced
    try:
        statuses = []
        for seq in range(1, 5):
            parent = _jax_delta(cfg.model_file, seq, parent, seed=seq, step=1 + seq)
            threads = [threading.Thread(target=lambda: statuses.append(
                eng.reload_once()["status"])) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            _scores(eng, probe)  # a flush swaps the stage in
        assert applied == [2, 3, 4, 5]  # in chain order, each once
        assert max(overlap) == 1
        assert statuses.count("staged_delta") == 4
        assert set(statuses) <= {"staged_delta", "busy", "noop"}
        assert eng.step == 5
        np.testing.assert_array_equal(_scores(eng, probe), _fresh(cfg, probe))
    finally:
        eng.close()


def test_submit_block_matches_per_row_submits(tmp_path):
    """One block == its rows submitted one by one, bitwise (one bucket
    each way); a row with an out-of-range id fails alone, typed."""
    jcfg, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=0.0)
    _jax_base(jcfg, seed=0, step=1)
    lines = [f"1 {i + 1}:1.0 {i + 10}:0.5 {3 * i + 2}:0.25" for i in range(6)]
    pb = parse_lines(lines, vocabulary_size=V, max_nnz=NNZ)
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        per_row = [eng.submit_line(ln).result(timeout=30) for ln in lines]
        st, sc = eng.submit_block(pb.ids, pb.vals).result(timeout=30)
        assert list(st) == [0] * 6
        # The six rows in one bucket-16 flush against six bucket-1 flushes:
        # a bucket of another size may move the last float32 bit on the CPU.
        np.testing.assert_allclose(sc, per_row, rtol=0, atol=ATOL)
        one = [float(eng.submit_block(pb.ids[i:i + 1], pb.vals[i:i + 1]).result(timeout=30)[1][0])
               for i in range(6)]
        assert one == per_row  # bucket 1 both ways: bitwise
        bad = pb.ids.copy()
        bad[2, 0] = V + 99
        st2, sc2 = eng.submit_block(bad, pb.vals).result(timeout=30)
        assert FRAME_STATUS_CODES[st2[2]] == "bad_request" and sc2[2] == 0
        assert [int(st2[i]) for i in (0, 1, 3, 4, 5)] == [0] * 5
        with pytest.raises(ValueError):
            eng.submit_block(pb.ids[:, :3], pb.vals)  # ragged
        with pytest.raises(ValueError):
            eng.submit_block(np.zeros((17, NNZ), np.int32), np.zeros((17, NNZ), np.float32))
        jeng = JaxServingEngine(jcfg, log=quiet)
        try:
            jst, jsc = jeng.submit_block(pb.ids, pb.vals).result(timeout=60)
        finally:
            jeng.close()
        assert list(jst) == list(st)
        np.testing.assert_allclose(sc, np.asarray(jsc), rtol=0, atol=ATOL)


def test_submit_block_bucket_after_coalesce(tmp_path):
    """Two blocks queued within one flush window coalesce into ONE bucket
    sized for their sum; per-bucket rows and padding in the snapshot; the
    frame rows count as requests."""
    jcfg, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=200.0)
    _jax_base(jcfg, seed=0, step=1)
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        ids = np.arange(1, 7, dtype=np.int32).reshape(3, 2)
        vals = np.ones((3, 2), np.float32)
        f1 = eng.submit_block(ids, vals)
        f2 = eng.submit_block(ids + 10, vals)
        f1.result(timeout=30), f2.result(timeout=30)
        snap = eng.metrics_snapshot()
    assert snap["flushes"] == 1 and snap["requests"] == 6
    assert snap["bucket_rows"] == {"16": 6}
    assert snap["bucket_padded_rows"] == {"16": 10}
    assert snap["bucket_occupancy"] == {"16": round(6 / 16, 4)}


def test_expired_block_rows_answer_deadline_and_evicted_blocks_overloaded(tmp_path):
    """Rows past their own deadline answer `deadline` inside the block's one
    response; a queued block evicted by a higher tier answers `overloaded`
    on every row (a block resolves, never raises)."""
    jcfg, cfg = _cfgs(tmp_path, serve_flush_deadline_ms=100.0, serve_queue_size=1,
                      serve_overload="reject", serve_classes=(("gold", 2),))
    _jax_base(jcfg, seed=0, step=1)
    with ServingEngine(cfg, log=quiet, device="cpu") as eng:
        ids = np.arange(1, 5, dtype=np.int32).reshape(2, 2)
        vals = np.ones((2, 2), np.float32)
        late = eng.submit_block(ids, vals, deadlines_ms=[1e-3, 0])
        st, sc = late.result(timeout=30)
        assert [FRAME_STATUS_CODES[s] for s in st] == ["deadline", "ok"] and sc[0] == 0
        eng.inject_slow(300, 1)
        eng.submit_block(ids, vals)  # sleeps in its flush
        time.sleep(0.15)
        low = eng.submit_block(ids, vals)  # queued behind it
        eng.submit_block(ids, vals, classes=["gold", "gold"])  # evicts it
        st, _ = low.result(timeout=30)
        assert [FRAME_STATUS_CODES[s] for s in st] == ["overloaded", "overloaded"]
        snap = eng.metrics_snapshot()
    assert snap["deadline_drops"] == 1 and snap["evicted"] == 2


def test_a_full_save_resets_the_chain_without_a_hole(tmp_path, monkeypatch):
    """The port's full save unlinks the old deltas newest first: after each
    removal the chain on disk still reads (the base and a prefix of its
    deltas), so a live reload never counts a broken chain and a crash
    mid-reset leaves a restorable checkpoint."""
    from fast_tffm_tpu_torch import checkpoint as ckpt
    from fast_tffm_tpu_torch.weights import from_jax_arrays

    path = str(tmp_path / "m.ckpt")
    table = np.random.default_rng(0).uniform(-0.3, 0.3, (V, 1 + K)).astype(np.float32)
    state = from_jax_arrays(table, [], 1, torch.device("cpu"),
                            table_accum=np.full((V, 1), 0.1, np.float32))
    ckpt.save_checkpoint(path, state)
    parent = ckpt.checkpoint_save_id(path)
    for seq in (1, 2, 3):
        _, parent, _ = ckpt.save_delta(
            path, seq, idx=np.array([seq]), table_rows=table[seq:seq + 1],
            accum_rows=np.full((1, 1), 0.2, np.float32), dense_leaves=[],
            dense_accum_leaves=[], step=1 + seq, parent_sig=parent)
    seen, real = [], os.remove

    def remove(p):
        real(p)
        seen.append(len(ckpt.read_delta_chain(path)[1]))  # raises on a hole

    monkeypatch.setattr(ckpt.os, "remove", remove)
    ckpt.save_checkpoint(path, state)
    assert seen == [2, 1, 0] and ckpt.delta_paths(path) == []
