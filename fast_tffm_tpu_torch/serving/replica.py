"""Replica worker: one ServingEngine on one device behind a socket, spoken
to by the router.

The port's counterpart of ``fast_tffm_tpu/serving/replica.py``: a process
that owns ONE engine (its own CUDA context, table copy, admission queue and
telemetry monitor) and answers the wire protocol (protocol.py) on a TCP
socket.  Launched by serving/router.py, or by hand:

    python -m fast_tffm_tpu_torch.serving.replica run.cfg --replica 0 --port 0 [--device cpu]

``--device`` defaults to cuda; without a CUDA device (and without
``--device cpu``) the engine raises before anything is announced, so the
router fails its bring-up typed instead of scoring on the CPU.  On start it
binds (``--port 0`` = ephemeral), builds and warms the engine (restore,
every bucket scored once: the kernel library loaded), and only THEN prints
the line the router waits for::

    REPLICA_READY port=<port> pid=<pid>

Ops beyond ``score``:

  * ``hello``  → upgrades the connection to binary DATA frames when
    ``serve_wire`` allows (the ack carries max_frame_rows, max_nnz, fields);
  * ``ping``   → engine.health() (the router's wedge signal);
  * ``reload`` → one engine.reload_once() tick on its own thread, so
    scoring keeps flowing during a full restore; the ack carries the
    outcome (noop / staged / staged_delta / failed / backoff / busy);
  * ``stats``  → the engine's metrics snapshot and health, the JAX keys,
    plus the device and the kernel wrappers' launch counts in this process;
  * ``slow``   → engine.inject_slow;
  * ``close``  → drain and exit 0.

The engine's own reload watcher is forced off here: the router owns the one
checkpoint watcher and fans ``reload`` out, so each write is applied once
per replica.  Every admitted request gets exactly one response, a score or
a typed code; the socket is never just dropped.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import socket
import sys
import threading
import time

import numpy as np

from fast_tffm_tpu_torch.serving.protocol import (
    FRAME_KIND_REQUEST,
    FRAME_STATUS_CODES,
    REPLICA_READY_PREFIX,
    BadRequest,
    decode,
    encode,
    error_response,
    exc_code,
    pack_error_frame,
    pack_scores_frame,
    read_frame,
    unpack_request_frame,
)

__all__ = ["run_replica", "main", "launch_counts"]


def launch_counts() -> dict:
    """The kernel wrappers' launch counts in this process, by kernel name."""
    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_bwd
    from fast_tffm_tpu_torch.ops.fm import fm2_score_bwd, fm2_score_fwd
    from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update

    return {
        "anova_fwd": anova_inter.launches,
        "anova_bwd": anova_inter_bwd.launches,
        "rows_tail_adagrad": rows_tail_adagrad_update.launches,
        "fused_tail_adagrad": fused_tail_adagrad_update.launches,
        "fm2_fwd": fm2_score_fwd.launches,
        "fm2_bwd": fm2_score_bwd.launches,
    }


class _Conn:
    """One connection (the router's data or control link, or an affinity-
    pinned client): a reader loop plus a write lock (scores resolve on the
    collector thread, acks on the reader and reload threads; whole writes
    must not interleave).  It starts in JSONL mode; a ``{"op": "hello",
    "wire": "binary"}`` line upgrades it to DATA frames when ``wire``
    allows, else the ack refuses and the client keeps speaking lines."""

    def __init__(self, sock: socket.socket, engine, log, wire: str = "binary"):
        self._sock = sock
        self._engine = engine
        self._log = log
        self._wire = wire
        self._upgraded = False
        self._wlock = threading.Lock()
        self._reload_lock = threading.Lock()  # one reload at a time

    def send(self, obj: dict) -> None:
        self.send_bytes(encode(obj))

    def send_bytes(self, data: bytes) -> None:
        try:
            with self._wlock:
                # The peer reads eagerly on its own thread; a peer that
                # wedges is killed or closed by the router's health layer,
                # which unblocks this send with OSError.
                self._sock.sendall(data)
        except OSError:
            pass  # the peer is gone; its reconnect (or our exit) handles it

    def _score(self, msg: dict) -> None:
        req_id = msg.get("id")
        fut = self._engine.submit_line(
            str(msg["line"]),
            klass=str(msg.get("class", "") or ""),
            deadline_ms=msg.get("deadline_ms"),
            deadline_at=msg.get("deadline_at"),
        )

        def done(f, req_id=req_id):
            exc = f.exception()
            if exc is None:
                self.send({"id": req_id, "score": float(f.result())})
            else:
                self.send(error_response(req_id, exc))

        fut.add_done_callback(done)

    def _reload(self, msg: dict) -> None:
        def work():
            with self._reload_lock:
                try:
                    out = self._engine.reload_once()
                except Exception as e:  # a reload crash must not kill the worker
                    out = {"status": "failed", "error": repr(e)}
            self.send({"id": msg.get("id"), "ok": True, "op": "reload", **out})

        threading.Thread(target=work, name="replica-reload", daemon=True).start()

    def handle(self, msg: dict) -> bool:
        """Dispatch one request; False = close this worker."""
        req_id = msg.get("id")
        if "line" in msg:
            self._score(msg)
            return True
        op = msg.get("op")
        if op == "hello":
            want = str(msg.get("wire", "jsonl") or "jsonl").lower()
            granted = "binary" if (want == "binary" and self._wire == "binary") else "jsonl"
            self.send({
                "id": req_id,
                "ok": True,
                "op": "hello",
                "wire": granted,
                "max_frame_rows": self._engine.max_batch,
                "max_nnz": self._engine.max_nnz,
                "fields": self._engine.uses_fields,
            })
            # The ack is the last JSONL line of an upgraded connection.
            self._upgraded = granted == "binary"
        elif op == "ping":
            self.send({"id": req_id, "ok": True, "op": "ping", **self._engine.health()})
        elif op == "stats":
            self.send({
                "id": req_id,
                "ok": True,
                "op": "stats",
                "pid": os.getpid(),
                "engine": self._engine.metrics_snapshot(),
                "compile_count": self._engine.compile_count(),
                "device": str(self._engine.device),
                "launches": launch_counts(),
                **self._engine.health(),
            })
        elif op == "slow":
            self._engine.inject_slow(float(msg.get("ms", 0.0)), int(msg.get("flushes", 1)))
            self.send({"id": req_id, "ok": True, "op": "slow"})
        elif op == "reload":
            self._reload(msg)
        elif op == "close":
            self.send({"id": req_id, "ok": True, "op": "close"})
            return False
        else:
            self.send(error_response(req_id, ValueError(f"unknown op {op!r}")))
        return True

    def serve(self) -> bool:
        """Read until EOF; True = a ``close`` op asked the worker to exit."""
        buf = self._sock.makefile("rb")
        for line in buf:
            line = line.strip()
            if not line:
                continue
            try:
                msg = decode(line)
            except BadRequest as e:
                self.send(error_response(None, e))
                continue
            try:
                if not self.handle(msg):
                    return True
            except Exception as e:
                # submit_line raising (overload, parse, closed engine): a
                # typed response, never a dropped line.
                self.send(error_response(msg.get("id"), e))
            if self._upgraded:
                return self._serve_frames(buf)
        return False

    def _answer_all(self, req_ids: np.ndarray, code: str) -> None:
        """One SCORES frame failing every row with ``code``: how whole-frame
        errors (overload, closed engine) stay typed and per-request."""
        n = int(req_ids.size)
        self.send_bytes(pack_scores_frame(
            req_ids, np.full(n, FRAME_STATUS_CODES.index(code), np.uint8), np.zeros(n, np.float32)
        ))

    def _serve_frames(self, buf) -> bool:
        """The binary DATA loop after the hello.  An undecodable PAYLOAD
        (header intact, stream in sync) gets an ERROR frame and the loop
        goes on; a broken HEADER (framing lost) gets an ERROR frame and the
        connection closes."""
        while True:
            try:
                fr = read_frame(buf)
            except BadRequest as e:
                self.send_bytes(pack_error_frame("bad_request", str(e)))
                return False
            if fr is None:
                return False  # clean EOF at a frame boundary
            kind, flags, count, width, payload = fr
            if kind != FRAME_KIND_REQUEST:
                self.send_bytes(pack_error_frame("bad_request", f"unexpected frame kind {kind}"))
                continue
            try:
                d = unpack_request_frame(flags, count, width, payload)
            except BadRequest as e:
                self.send_bytes(pack_error_frame("bad_request", str(e)))
                continue
            req_ids = d["req_ids"]
            try:
                fut = self._engine.submit_block(
                    d["ids"], d["vals"], d["fields"],
                    deadlines_ms=d["deadlines_ms"], classes=d["classes"],
                )
            except Exception as e:
                self._answer_all(req_ids, exc_code(e))
                continue

            def done(f, req_ids=req_ids):
                exc = f.exception()
                if exc is None:
                    statuses, scores = f.result()
                    self.send_bytes(pack_scores_frame(req_ids, statuses, scores))
                else:
                    self._answer_all(req_ids, exc_code(exc))

            fut.add_done_callback(done)


# How long a starting replica retries a torn checkpoint (a publish caught
# mid-write, or a torn file a trainer's next save replaces) before it exits;
# the router's readiness wait (180 s) bounds it from the outside.
TORN_START_RETRY_S = 60.0


def _start_engine(engine_cls, cfg, log, device, replica):
    """The replica's engine, its restore retried every 0.25 s while the
    checkpoint reads torn, for up to ``TORN_START_RETRY_S``: a replica the
    router restarts while a torn publish is on disk comes up when the file
    is whole again, as a running replica's reload retries it."""
    from fast_tffm_tpu_torch.checkpoint import TornCheckpointError

    deadline = time.monotonic() + TORN_START_RETRY_S
    for attempt in itertools.count():
        try:
            return engine_cls(cfg, log=log, device=device, replica=replica)
        except TornCheckpointError as e:
            if time.monotonic() >= deadline:
                raise
            if attempt == 0:
                log(f"restore failed ({e}); retrying until the checkpoint reads whole")
            time.sleep(0.25)


def run_replica(
    cfg,
    *,
    replica: int = 0,
    port: int = 0,
    host: str = "127.0.0.1",
    device=None,
    log=None,
    ready_out=None,
) -> int:
    """Build the engine on ``device`` (None = cuda), bind, announce
    readiness, serve until the router sends ``close`` (or the process is
    killed, which the router recovers from)."""
    from fast_tffm_tpu_torch.serving.engine import ServingEngine

    log = log or (lambda *a: print(f"replica {replica}:", *a, file=sys.stderr, flush=True))
    ready_out = ready_out or sys.stdout
    # The router owns reload fan-out, and the socket tier always SHEDS under
    # overload: a block-policy submit would wedge the reader thread (pings
    # included), and an overloaded replica would read as a dead one.
    overrides = {"serve_reload_interval_s": 0.0, "serve_overload": "reject"}
    if cfg.metrics_path:
        # One JSONL file per replica: appends from several processes to one
        # file interleave partial lines.
        overrides["metrics_path"] = f"{cfg.metrics_path}.r{replica}"
    cfg = dataclasses.replace(cfg, **overrides)
    srv = socket.create_server((host, port))
    try:
        engine = _start_engine(ServingEngine, cfg, log, device, replica)
    except BaseException:
        srv.close()
        raise
    actual = srv.getsockname()[1]
    print(f"{REPLICA_READY_PREFIX}port={actual} pid={os.getpid()}", file=ready_out, flush=True)
    log(f"listening on {host}:{actual} ({engine.device})")
    close_evt = threading.Event()
    try:
        srv.settimeout(0.5)

        # A thread per connection: the router holds a DATA and a CONTROL
        # connection, so health checks never queue behind a score backlog.
        def serve_conn(conn):
            try:
                if _Conn(conn, engine, log, wire=cfg.serve_wire).serve():
                    close_evt.set()
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        while not close_evt.is_set():
            try:
                conn, _ = srv.accept()
            except TimeoutError:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=serve_conn, args=(conn,), daemon=True).start()
    finally:
        try:
            srv.close()
        finally:
            engine.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fast_tffm_tpu_torch.serving.replica",
        description="serving replica worker (spawned by the router)",
    )
    ap.add_argument("config", help="INI config file")
    ap.add_argument("--replica", type=int, default=0, metavar="N")
    ap.add_argument("--port", type=int, default=0, metavar="P",
                    help="listen port (0 = ephemeral, announced on stdout)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--run-id", default=None, metavar="ID")
    ap.add_argument("--metrics-path", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    from fast_tffm_tpu_torch.config import load_config

    cfg = load_config(args.config)
    if args.metrics_path is not None:
        cfg.metrics_path = args.metrics_path
    if args.run_id is not None:
        cfg.telemetry_run_id = args.run_id
    return run_replica(cfg, replica=args.replica, port=args.port, host=args.host,
                       device=args.device)


if __name__ == "__main__":
    sys.exit(main())
