"""Port: the replicated serving tier (router, replica connection, front
end, clients) on the CPU.

The router's failover, retry-once, restart budget, wedge kill and reload
fan-out run the port's REAL ``Router`` against FAKE replica workers (thread-
backed socket servers with deterministic scores and scripted deaths, the
counterparts of the JAX package's ``tests/test_serving_router.py``), so
counts are exact and no process is spawned.  The replica connection's wire
(hello upgrade, a JSONL pin, torn frames) runs over a socketpair against a
stub engine.  Then the real thing: ``python -m fast_tffm_tpu_torch.cli
serve <cfg> --port 0 --device cpu`` with two replica processes answers the
port's ``serve_lines`` scores over JSONL and binary frames, the JAX
package's ``FrameConnection`` gets the same scores from it (one wire), and
a SIGKILLed pinned replica fails over to its peer, rescored identically.
Every wait is bounded by a deadline.
"""

import io
import json
import os
import signal
import socket
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fast_tffm_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from fast_tffm_tpu.config import Config as JaxConfig
from fast_tffm_tpu.config import build_model as jax_build_model
from fast_tffm_tpu.serving.client import FrameConnection as JaxFrameConnection
from fast_tffm_tpu.trainer import init_state as jax_init_state
from fast_tffm_tpu_torch.config import Config, load_config
from fast_tffm_tpu_torch.data.libsvm import parse_lines
from fast_tffm_tpu_torch.serving import serve_lines
from fast_tffm_tpu_torch.serving.client import (
    FrameConnection,
    ServeConnection,
    WireRefused,
    spawn_serve,
)
from fast_tffm_tpu_torch.serving.protocol import (
    FRAME_HEADER,
    FRAME_KIND_ERROR,
    FRAME_KIND_REQUEST,
    FRAME_KIND_SCORES,
    FRAME_MAGIC,
    FRAME_VERSION,
    Unavailable,
    decode,
    encode,
    pack_request_frame,
    read_frame,
    unpack_error_frame,
    unpack_scores_frame,
)
from fast_tffm_tpu_torch.serving.replica import _Conn
from fast_tffm_tpu_torch.serving.router import Router

V = 128
NNZ = 6
ATOL = 1e-6


def _cfg(tmp_path, **kw):
    kw.setdefault("model", "fm")
    kw.setdefault("factor_num", 4)
    kw.setdefault("vocabulary_size", V)
    kw.setdefault("max_nnz", NNZ)
    kw.setdefault("model_file", str(tmp_path / "m.ckpt"))
    kw.setdefault("serve_buckets", (1, 4, 16))
    kw.setdefault("serve_flush_deadline_ms", 20.0)
    return Config(**kw).validate()


def _jax_checkpoint(path, shift=0.5, step=0, order=2, factor_num=4, vocab=V):
    jcfg = JaxConfig(model="fm", order=order, factor_num=factor_num,
                     vocabulary_size=vocab, model_file=str(path)).validate()
    state = jax_init_state(jax_build_model(jcfg), jax.random.key(0), 0.1)
    table = np.random.default_rng(int(100 * shift) + step).uniform(
        -0.3, 0.3, (vocab, 1 + factor_num)).astype(np.float32)
    jax_save_checkpoint(str(path), state._replace(table=jnp.asarray(table),
                                                  step=state.step + step), "npz")


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------------------
# the router against fake replicas
# ---------------------------------------------------------------------------


def _fake_score(line: str) -> float:
    """Deterministic, replica-independent scoring stand-in."""
    return float(sum(line.encode()) % 1000) / 1000.0


class FakeReplica:
    """Thread-backed replica worker double (the router's ReplicaProcess
    duck-type).  ``die_at_request=N`` closes the connection upon RECEIVING
    the Nth score request without answering: a death mid-flight.
    ``wedged`` swallows scores and reports no flush progress."""

    def __init__(self, index: int, die_at_request: int | None = None, wedged: bool = False):
        self.index = index
        self.die_at_request = die_at_request
        self.wedged = wedged
        self.reloads = 0
        self.pings = 0
        self.scored = 0
        self.received = 0
        self.dead = False
        self.pid = None
        self._srv = socket.create_server(("127.0.0.1", 0))
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def returncode(self):
        return -9 if self.dead else None

    def alive(self):
        return not self.dead

    def kill(self):
        self.dead = True
        try:
            self._srv.close()
        except OSError:
            pass

    def wait(self, timeout=None):
        pass

    def _serve(self):
        def one(conn):
            try:
                self._handle(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        while not self.dead:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=one, args=(conn,), daemon=True).start()

    def _handle(self, conn):
        for raw in conn.makefile("rb"):
            raw = raw.strip()
            if not raw:
                continue
            msg = json.loads(raw)
            if "line" in msg:
                self.received += 1
                if self.wedged:
                    continue
                if self.die_at_request is not None and self.received >= self.die_at_request:
                    self.kill()
                    return
                self.scored += 1
                conn.sendall(encode({"id": msg["id"], "score": _fake_score(msg["line"])}))
            elif msg.get("op") == "ping":
                self.pings += 1
                conn.sendall(encode({
                    "id": msg["id"], "ok": True, "op": "ping", "oldest_wait_s": None,
                    "queue_depth": 1 if self.wedged else 0,
                    "last_flush_age_s": 99.0 if self.wedged else 0.01,
                }))
            elif msg.get("op") == "reload":
                self.reloads += 1
                conn.sendall(encode({"id": msg["id"], "ok": True, "op": "reload",
                                     "status": "staged"}))
            elif msg.get("op") == "stats":
                conn.sendall(encode({"id": msg["id"], "ok": True, "op": "stats",
                                     "scored": self.scored}))
            elif msg.get("op") == "close":
                conn.sendall(encode({"id": msg.get("id"), "ok": True, "op": "close"}))
                return


def _fake_router(cfg, fakes, plan, **kw):
    """A Router over FakeReplica launches; ``plan[index]`` is a list of
    constructor kwargs consumed launch by launch (relaunches pop on)."""

    def launcher(index):
        kws = plan.get(index, [{}])
        fake = FakeReplica(index, **(kws.pop(0) if kws else {}))
        fakes.append(fake)
        return fake

    kw.setdefault("health_interval_s", 0.1)
    kw.setdefault("ping_timeout_s", 1.0)
    kw.setdefault("log", lambda *a: None)
    return Router(cfg, launcher=launcher, **kw)


def test_router_failover_rescored_identically(tmp_path):
    """Replica 0 dies upon receiving a request: the router retries it ONCE
    on replica 1 and the caller sees the score replica 0 would have given;
    the slot restarts with a measured MTTR."""
    cfg = _cfg(tmp_path, serve_replicas=2, restart_backoff_s=0.01)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict(die_at_request=2), dict()], 1: [dict()]})
    try:
        lines = [f"1 {i + 1}:1.0" for i in range(8)]
        futs = [router.submit(ln) for ln in lines]
        for ln, fut in zip(lines, futs):
            assert fut.result(timeout=10) == pytest.approx(_fake_score(ln)), ln
        snap = router.snapshot()
        # Replica 0 was routed 4 of the 8 requests (round-robin).  Each is
        # retried at most once; even the one it answered before dying is
        # retried when a send failure declares it down before the reader
        # has taken that answer off the socket.
        assert 1 <= snap["failovers"] <= 4 and snap["failed_unanswerable"] == 0
        dead = fakes[0] if fakes[0].dead else fakes[1]
        assert dead.scored < dead.received
        assert _until(lambda: all(s.state == "healthy" for s in router.slots))
        snap = router.snapshot()
        assert snap["replicas"][0]["restarts"] == 1
        assert len(snap["mttr_s"]) == 1 and snap["mttr_s"][0] > 0
        assert router.submit("1 50:1.0").result(timeout=10) == pytest.approx(
            _fake_score("1 50:1.0"))
    finally:
        router.close()


def test_router_links_have_no_read_timeout_and_a_lost_link_kills_its_replica(tmp_path):
    """A replica's DATA link may idle longer than the 30 s connect bound (its
    clients pinned to it over frames): the links carry no read timeout, so
    an idle link is never read as a lost one.  A link that is lost while
    its replica still runs kills that replica before the slot restarts:
    never two processes for one index."""
    cfg = _cfg(tmp_path, serve_replicas=1, restart_backoff_s=0.01)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict(), dict()]})
    try:
        slot = router.slots[0]
        assert slot.sock.gettimeout() is None and slot.ctrl.gettimeout() is None
        first = fakes[0]
        router._on_down(slot, "connection lost")
        assert first.dead
        assert _until(lambda: router.slots[0].state == "healthy" and len(fakes) == 2)
    finally:
        router.close()


def test_router_retry_is_once_then_typed_unavailable(tmp_path):
    cfg = _cfg(tmp_path, serve_replicas=2, restart_max=0)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict(die_at_request=1)], 1: [dict(die_at_request=1)]})
    try:
        with pytest.raises(Unavailable):
            router.submit("1 1:1.0").result(timeout=10)
        assert router.snapshot()["failed_unanswerable"] >= 1
        assert sum(f.received for f in fakes) == 2  # the first try and ONE retry
    finally:
        router.close()


def test_router_no_healthy_replica_fails_fast(tmp_path):
    cfg = _cfg(tmp_path, serve_replicas=1, restart_max=0)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict()]})
    try:
        fakes[0].kill()
        assert _until(lambda: router.slots[0].state != "healthy")
        t0 = time.monotonic()
        with pytest.raises(Unavailable):
            router.submit("1 1:1.0").result(timeout=5)
        assert time.monotonic() - t0 < 1.0
        with pytest.raises(Unavailable):
            router.assign()  # an affinity hello gets a typed answer too
    finally:
        router.close()


def test_router_restart_budget_gives_up(tmp_path):
    """restart_max bounds relaunches; the slot parks in `failed` and the
    survivor keeps serving."""
    cfg = _cfg(tmp_path, serve_replicas=2, restart_max=0)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict(die_at_request=1)], 1: [dict()]})
    try:
        assert router.submit("1 1:1.0").result(timeout=10) == pytest.approx(
            _fake_score("1 1:1.0"))
        assert _until(lambda: router.slots[0].state == "failed")
        assert len(fakes) == 2  # no relaunch
        assert router.submit("1 2:1.0").result(timeout=10) == pytest.approx(
            _fake_score("1 2:1.0"))
    finally:
        router.close()


def test_router_kills_wedged_replica_and_fails_typed(tmp_path):
    """A collector hung after popping its requests (pongs, no flush, the
    router holding unanswered scores) is declared wedged: killed, its
    request fails typed, and a restart brings a healthy replacement."""
    cfg = _cfg(tmp_path, serve_replicas=1, restart_backoff_s=0.01)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict(wedged=True), dict()]}, wedge_timeout_s=0.3)
    try:
        with pytest.raises(Unavailable):
            router.submit("1 1:1.0").result(timeout=10)
        assert fakes[0].dead
        assert _until(lambda: router.slots[0].state == "healthy")
        assert router.submit("1 2:1.0").result(timeout=10) == pytest.approx(
            _fake_score("1 2:1.0"))
    finally:
        router.close()


def test_watcher_fans_out_one_reload_per_write_per_replica(tmp_path):
    """One checkpoint write -> exactly ONE reload command on EACH replica."""
    cfg = _cfg(tmp_path, serve_replicas=2, serve_reload_interval_s=0.05)
    _jax_checkpoint(cfg.model_file, shift=0.5, step=0)
    fakes = []
    router = _fake_router(cfg, fakes, {0: [dict()], 1: [dict()]})
    try:
        time.sleep(0.2)  # several watcher ticks: no write, no fan-out
        assert router.reload_fanouts == 0 and [f.reloads for f in fakes] == [0, 0]
        _jax_checkpoint(cfg.model_file, shift=0.7, step=10)
        assert _until(lambda: all(f.reloads >= 1 for f in fakes))
        time.sleep(0.3)  # more ticks: still once
        assert router.reload_fanouts == 1
        assert [f.reloads for f in fakes] == [1, 1]
        assert [s.reload_acks for s in router.slots] == [1, 1]
        assert router.snapshot()["freshness_staged_ms"]["count"] == 2
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the replica connection's wire, against a stub engine
# ---------------------------------------------------------------------------


class _StubBlockEngine:
    """submit_block stand-in: row i scores sum(vals[i]), statuses all ok."""

    max_batch = 64
    max_nnz = 6
    uses_fields = False

    def submit_block(self, ids, vals, fields=None, *, deadlines_ms=None, classes=None):
        import concurrent.futures

        vals = np.asarray(vals, np.float32)
        fut = concurrent.futures.Future()
        fut.set_result((np.zeros(len(vals), np.uint8), vals.sum(axis=1).astype(np.float32)))
        return fut


def _conn_pair(engine, wire="binary"):
    server, client = socket.socketpair()
    conn = _Conn(server, engine, lambda *_: None, wire=wire)
    t = threading.Thread(target=conn.serve, daemon=True)
    t.start()
    client.settimeout(30)
    return client, client.makefile("rb"), t


def test_conn_hello_upgrades_to_frames():
    client, rf, _ = _conn_pair(_StubBlockEngine())
    client.sendall(encode({"id": 1, "op": "hello", "wire": "binary"}))
    ack = decode(rf.readline())
    assert ack["wire"] == "binary" and ack["max_frame_rows"] == 64 and ack["max_nnz"] == 6
    vals = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    client.sendall(pack_request_frame(np.array([7, 8], np.uint32), np.zeros((2, 2), np.int32),
                                      vals))
    kind, _, count, _, payload = read_frame(rf)
    assert kind == FRAME_KIND_SCORES
    req, st, sc = unpack_scores_frame(count, payload)
    assert list(req) == [7, 8] and list(st) == [0, 0] and list(sc) == [3.0, 7.0]
    client.close()


def test_conn_jsonl_pin_refuses_upgrade():
    client, rf, _ = _conn_pair(_StubBlockEngine(), wire="jsonl")
    client.sendall(encode({"id": 1, "op": "hello", "wire": "binary"}))
    assert decode(rf.readline())["wire"] == "jsonl"
    client.sendall(encode({"id": 2, "op": "close"}))  # still JSONL
    assert decode(rf.readline())["op"] == "close"
    client.close()


def test_conn_torn_frame_typed_error_never_hung():
    """A torn payload (header intact): an ERROR frame and the stream goes
    on.  A broken header (framing lost): an ERROR frame, then EOF."""
    client, rf, t = _conn_pair(_StubBlockEngine())
    client.sendall(encode({"id": 1, "op": "hello", "wire": "binary"}))
    decode(rf.readline())
    short = b"\x00" * 32
    client.sendall(FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION, FRAME_KIND_REQUEST, 0, 9, 4,
                                     len(short)) + short)
    kind, _, _, _, payload = read_frame(rf)
    assert kind == FRAME_KIND_ERROR and unpack_error_frame(payload)[0] == "bad_request"
    client.sendall(pack_request_frame(np.array([5], np.uint32), np.zeros((1, 2), np.int32),
                                      np.ones((1, 2), np.float32)))
    assert read_frame(rf)[0] == FRAME_KIND_SCORES
    client.sendall(b"GARBAGE!" * 4)
    kind, _, _, _, payload = read_frame(rf)
    assert kind == FRAME_KIND_ERROR and unpack_error_frame(payload)[0] == "bad_request"
    assert read_frame(rf) is None
    t.join(timeout=10)
    assert not t.is_alive()
    client.close()


def test_frame_connection_wire_refused_falls_back():
    """A front end that will not grant binary+affinity: WireRefused with
    the ack, the caller's cue to fall back to the JSONL ServeConnection."""
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def frontend():
        c, _ = srv.accept()
        msg = decode(c.makefile("rb").readline())
        c.sendall(encode({"id": msg.get("id"), "ok": True, "op": "hello", "wire": "jsonl",
                          "affinity": False}))
        c.close()

    t = threading.Thread(target=frontend, daemon=True)
    t.start()
    with pytest.raises(WireRefused) as ei:
        FrameConnection(port, timeout=10)
    assert ei.value.ack["wire"] == "jsonl"
    t.join(10)
    srv.close()


# ---------------------------------------------------------------------------
# the real tier: cli serve --port 0 --device cpu with two replica processes
# ---------------------------------------------------------------------------

TIER_V = 512
TIER_NNZ = 11


def _tier_lines(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, TIER_NNZ + 1))
        ids = rng.choice(TIER_V, size=k, replace=False)
        vals = np.round(rng.uniform(0.05, 1.0, size=k), 4)
        out.append("1 " + " ".join(f"{i}:{v}" for i, v in zip(ids, vals)))
    return out


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    """The port's front end over two CPU replica processes, serving an
    order-3 FM (k 8, max_nnz 11) from a JAX-written npz."""
    tmp = tmp_path_factory.mktemp("tier")
    model = tmp / "m.ckpt"
    _jax_checkpoint(model, shift=0.3, step=4, order=3, factor_num=8, vocab=TIER_V)
    cfg_path = tmp / "run.cfg"
    cfg_path.write_text(
        f"[General]\nmodel = fm\norder = 3\nfactor_num = 8\nvocabulary_size = {TIER_V}\n"
        f"model_file = {model}\n[Train]\nmax_nnz = {TIER_NNZ}\n"
        "[Serving]\nbuckets = 1 4 16\nflush_deadline_ms = 2\nreplicas = 2\n"
        "[Resilience]\nrestart_backoff_s = 0.1\n"
    )
    logs = []
    proc, port = spawn_serve(str(cfg_path), device="cpu", timeout_s=180, log=logs.append)
    try:
        yield SimpleNamespace(port=port, proc=proc, cfg=load_config(str(cfg_path)), logs=logs)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except Exception:
            proc.kill()
            proc.wait(timeout=10)


def _jsonl_scores(port, lines):
    conn = ServeConnection(port, timeout=30)
    try:
        for i, ln in enumerate(lines):
            conn.send({"id": i, "line": ln})
        assert not conn.wait_answered(range(len(lines)), 60)
        return np.array([conn.responses[i]["score"] for i in range(len(lines))], np.float64)
    finally:
        conn.close()


def _frame_scores(fc, lines, base=0):
    """One frame of <= 16 rows at a time, each answered before the next is
    sent: every frame flushes alone, at the bucket its own rows choose."""
    pb = parse_lines(lines, vocabulary_size=TIER_V, max_nnz=TIER_NNZ)
    for a in range(0, len(lines), 16):
        rid = np.arange(base + a, base + min(a + 16, len(lines)), dtype=np.uint32)
        fc.send_batch(rid, pb.ids[a:a + 16], pb.vals[a:a + 16])
        assert not fc.wait_answered(rid, 60)
    out = [fc.results[base + i] for i in range(len(lines))]
    assert {st for st, _ in out} == {"ok"}, out
    return np.array([sc for _, sc in out], np.float64)


def test_cli_serve_port_answers_the_serve_lines_scores(tier):
    lines = _tier_lines(48, seed=1)
    got = _jsonl_scores(tier.port, lines)
    out = io.StringIO()
    serve_lines(tier.cfg, lines, out=out, log=lambda *a: None, device="cpu")
    printed = np.array([float(s) for s in out.getvalue().split()])
    # serve_lines prints %.6f; flushes of other sizes may move the last bit.
    assert np.abs(got - printed).max() <= 5e-7 + ATOL
    ping = ServeConnection(tier.port, timeout=30)
    try:
        snap = ping.request({"op": "ping"}, timeout=30)
        stats = ping.request({"op": "stats"}, timeout=60)
    finally:
        ping.close()
    assert [r["state"] for r in snap["replicas"]] == ["healthy", "healthy"]
    for eng in stats["engines"].values():
        assert eng["device"] == "cpu" and eng["steady_compiles"] == 0
        assert eng["launches"]["anova_fwd"] == 0  # the CPU runs the plain version
    assert sum(e["engine"]["requests"] for e in stats["engines"].values()) >= len(lines)


def test_frames_of_both_packages_get_the_same_scores(tier):
    """The port's and the JAX package's FrameConnection against the port's
    front end (affinity: straight to a replica): bitwise equal, and within
    1e-6 of the JSONL path."""
    lines = _tier_lines(48, seed=2)
    jsonl = _jsonl_scores(tier.port, lines)
    fc, jfc = FrameConnection(tier.port, timeout=30), JaxFrameConnection(tier.port, timeout=30)
    try:
        assert fc.replica in (0, 1) and jfc.replica in (0, 1)
        assert fc.max_frame_rows == 16 and fc.max_nnz == TIER_NNZ and not fc.uses_fields
        ours = _frame_scores(fc, lines)
        theirs = _frame_scores(jfc, lines)
    finally:
        fc.close()
        jfc.close()
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours, jsonl, rtol=0, atol=ATOL)


def test_sigkill_of_a_pinned_replica_fails_over_bit_identically(tier):
    """SIGKILL the replica a FrameConnection is pinned to: the next frames
    re-pin to the peer once (client-driven retry), every row is answered
    and rescored bitwise; the router restarts the replica (MTTR > 0)."""
    lines = _tier_lines(32, seed=3)
    fc = FrameConnection(tier.port, timeout=30)
    ops = ServeConnection(tier.port, timeout=30)
    try:
        base = _frame_scores(fc, lines)
        stats = ops.request({"op": "stats"}, timeout=60)
        os.kill(stats["replicas"][fc.replica]["pid"], signal.SIGKILL)
        again = _frame_scores(fc, lines, base=1000)
        assert fc.failovers == 1
        np.testing.assert_array_equal(again, base)

        def restarted():
            snap = ops.request({"op": "ping"}, timeout=30)
            return all(r["state"] == "healthy" for r in snap["replicas"]) and snap["mttr_s"]

        assert _until(restarted, timeout=120)
        snap = ops.request({"op": "ping"}, timeout=30)
        assert len(snap["mttr_s"]) == 1 and snap["mttr_s"][0] > 0
        assert sum(r["restarts"] for r in snap["replicas"]) == 1
    finally:
        fc.close()
        ops.close()
