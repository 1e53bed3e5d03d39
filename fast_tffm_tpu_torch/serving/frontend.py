"""Socket front end: the network door to the replicated serving tier.

The port's counterpart of ``fast_tffm_tpu/serving/frontend.py``: a stdlib
``socketserver.ThreadingTCPServer`` speaking the JSONL wire protocol
(protocol.py).  Clients connect, pipeline any number of requests and read
responses keyed by their own ``id`` (out of order: micro-batching and
failover reorder).  Every request gets exactly one response line, a score
or a typed error code; admission control (deadlines, tiered shed) runs in
the replica engines, so the front end stays a thin multiplexer that holds
no state a failover would lose.

    python -m fast_tffm_tpu_torch.cli serve run.cfg --port 0   # ephemeral
    # [Serving] port / replicas in the config for a fixed deployment

On start it builds the router (which spawns and warms the replicas) BEFORE
binding, then announces::

    SERVE_READY port=<port> pid=<pid> replicas=<n>

on stdout.  Ops: ``hello`` (wire negotiation; with ``serve_affinity`` the
ack hands the client a healthy replica's port to pin its binary DATA
connection to), ``ping`` (the router's snapshot), ``stats`` (router and
per-replica engine stats), ``slow`` (latency injection, forwarded to one
replica).
"""

from __future__ import annotations

import os
import socketserver
import sys
import threading
import time

from fast_tffm_tpu_torch.serving.protocol import (
    SERVE_READY_PREFIX,
    BadRequest,
    decode,
    encode,
    error_response,
)
from fast_tffm_tpu_torch.serving.router import Router

__all__ = ["Frontend", "run_frontend"]


class _Handler(socketserver.StreamRequestHandler):
    # TCP_NODELAY on each client socket, as the router, replica and client
    # set on theirs: one small response line a write, which Nagle would
    # otherwise hold back until the client's delayed ACK.
    disable_nagle_algorithm = True

    def handle(self) -> None:
        router: Router = self.server.router  # type: ignore[attr-defined]
        wlock = threading.Lock()
        inflight = threading.Semaphore(self.server.max_pipeline)  # type: ignore[attr-defined]

        def send(obj: dict) -> None:
            try:
                with wlock:
                    self.wfile.write(encode(obj))
                    self.wfile.flush()
            except (OSError, ValueError):
                # Client went away; late future callbacks land on a
                # CLOSED wfile, which raises ValueError (not OSError) —
                # both just mean nobody is listening anymore.
                pass

        for raw in self.rfile:
            raw = raw.strip()
            if not raw:
                continue
            try:
                msg = decode(raw)
            except BadRequest as e:
                send(error_response(None, e))
                continue
            req_id = msg.get("id")
            if "line" in msg:
                # Anchor the deadline budget HERE, at wire receipt: an
                # absolute monotonic deadline travels with the request,
                # so seconds spent in TCP buffers or a backlogged replica
                # reader count against it — under overload the request is
                # shed typed instead of scored uselessly late.
                dl_ms = msg.get("deadline_ms")
                if dl_ms is None:
                    dl_ms = self.server.default_deadline_ms  # type: ignore[attr-defined]
                deadline_at = (
                    time.monotonic() + float(dl_ms) / 1e3 if dl_ms else None
                )
                # Per-connection pipeline bound: a client blasting faster
                # than the tier sheds would otherwise grow the router's
                # pending maps without limit.  Waiting here is plain TCP
                # backpressure on that one client.
                inflight.acquire()
                try:
                    fut = router.submit(
                        str(msg["line"]),
                        klass=str(msg.get("class", "") or ""),
                        deadline_at=deadline_at,
                    )
                except Exception as e:
                    inflight.release()
                    send(error_response(req_id, e))
                    continue

                def done(f, req_id=req_id):
                    inflight.release()
                    exc = f.exception()
                    if exc is None:
                        send({"id": req_id, "score": f.result()})
                    else:
                        send(error_response(req_id, exc))

                fut.add_done_callback(done)
                continue
            op = msg.get("op")
            try:
                if op == "hello":
                    # Wire negotiation + placement.  The ack
                    # names the wire the tier allows; with affinity on it
                    # also hands the client a healthy replica's port to
                    # pin its DATA connection to — the replica answers
                    # directly and the front end / router drop out of the
                    # score path.  On that replica's death the CLIENT
                    # re-hellos here for a peer (retry-once-on-peer).
                    want = str(msg.get("wire", "jsonl") or "jsonl").lower()
                    wire = self.server.wire  # type: ignore[attr-defined]
                    ack = {
                        "id": req_id,
                        "ok": True,
                        "op": "hello",
                        "wire": "binary" if (want == "binary" and wire == "binary") else "jsonl",
                        "affinity": self.server.affinity,  # type: ignore[attr-defined]
                    }
                    if self.server.affinity:  # type: ignore[attr-defined]
                        idx, rport = router.assign()
                        ack["replica"] = idx
                        ack["port"] = rport
                    send(ack)
                elif op == "ping":
                    send({"id": req_id, "ok": True, "op": "ping", **router.snapshot()})
                elif op == "stats":
                    send({"id": req_id, "ok": True, "op": "stats", **router.stats()})
                elif op == "slow":
                    ack = router.admin(
                        int(msg.get("replica", 0)),
                        "slow",
                        ms=float(msg.get("ms", 0.0)),
                        flushes=int(msg.get("flushes", 1)),
                    )
                    send({"id": req_id, "ok": True, "op": "slow", "ack": ack})
                else:
                    send(error_response(req_id, BadRequest(f"unknown op {op!r}")))
            except Exception as e:
                send(error_response(req_id, e))


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class Frontend:
    """Bind, serve on a background thread, introspect the real port
    (``port = 0`` = ephemeral — the collision-proof default for tests)."""

    def __init__(
        self,
        router: Router,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_pipeline: int = 1024,
        default_deadline_ms: float = 0.0,
        wire: str = "binary",
        affinity: bool = True,
    ):
        self._srv = _Server((host, port), _Handler)
        self._srv.router = router  # type: ignore[attr-defined]
        self._srv.max_pipeline = max_pipeline  # type: ignore[attr-defined]
        self._srv.default_deadline_ms = float(default_deadline_ms)  # type: ignore[attr-defined]
        self._srv.wire = wire  # type: ignore[attr-defined]
        self._srv.affinity = bool(affinity)  # type: ignore[attr-defined]
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="serve-frontend",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)


def run_frontend(
    cfg, config_path: str, *, port: int | None = None, device: str | None = None, log=None
) -> int:
    """The ``serve`` CLI verb's socket mode: router + replicas (each on
    ``device``) + front end, running until SIGTERM/SIGINT.  ``port``
    overrides [Serving] port (0 = ephemeral)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    stop = threading.Event()
    router = Router(
        cfg, config_path=config_path, run_id=cfg.telemetry_run_id, device=device, log=log
    )
    try:
        fe = Frontend(
            router,
            port=cfg.serve_port if port is None else port,
            default_deadline_ms=cfg.serve_deadline_ms,
            wire=cfg.serve_wire,
            affinity=cfg.serve_affinity,
        )
    except Exception:
        router.close()
        raise
    try:
        import signal as _signal

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                _signal.signal(sig, lambda *_: stop.set())
            except (ValueError, OSError):
                pass  # not the main thread (tests drive run_frontend directly)
        n = len(router.slots)
        log(
            f"serving: front end listening on {fe.host}:{fe.port} "
            f"({n} replica(s), run_id {router.run_id})"
        )
        print(
            f"{SERVE_READY_PREFIX}port={fe.port} pid={os.getpid()} replicas={n}",
            flush=True,
        )
        stop.wait()
        log("serving: front end shutting down")
        return 0
    finally:
        fe.close()
        router.close()
