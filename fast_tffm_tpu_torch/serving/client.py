"""Client side of the serving tier: pipelined wire connections and the
spawner.

The port's counterpart of ``fast_tffm_tpu/serving/client.py`` (the same
wire, so each package's client talks to either package's front end):

  * ``ServeConnection`` multiplexes JSONL requests by caller-assigned
    ``id``: attach a ``meta`` to each send and route responses through
    ``on_response(msg, meta)`` (return falsy to ALSO keep the message in
    ``responses``), or use ``responses`` and the synchronous ``request()``
    for ops;
  * ``FrameConnection`` hellos the front end for a replica, pins a binary
    DATA connection to it and fails over to a peer once;
  * ``spawn_serve`` launches the port's ``serve --port`` and waits for
    ``SERVE_READY``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

from fast_tffm_tpu_torch.serving.protocol import (
    FRAME_KIND_ERROR,
    FRAME_KIND_SCORES,
    FRAME_STATUS_CODES,
    SERVE_READY_PREFIX,
    BadRequest,
    decode,
    encode,
    pack_request_frame,
    read_frame,
    unpack_error_frame,
    unpack_scores_frame,
)
from fast_tffm_tpu_torch.telemetry import log_quietly

__all__ = ["FrameConnection", "ServeConnection", "WireRefused", "spawn_serve"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _SyncBox:
    """Meta marker that turns a response into a synchronous result."""

    def __init__(self):
        self.event = threading.Event()
        self.msg = None


class ServeConnection:
    """One pipelined TCP connection to a front end (or replica — same
    wire).  Thread-safe sends; one reader thread resolves responses."""

    def __init__(self, port: int, host: str = "127.0.0.1", on_response=None,
                 timeout: float = 60.0):
        import socket as _socket

        self.sock = _socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._f = self.sock.makefile("rb")
        self._on_response = on_response
        self.lock = threading.Lock()
        self._pending: dict = {}  # id -> meta
        self.responses: dict = {}  # id -> msg (unconsumed responses)
        self._next = 0
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def next_id(self) -> int:
        with self.lock:
            self._next += 1
            return self._next

    def send(self, msg: dict, meta=None) -> None:
        """Send one message; ``msg['id']`` is the response key (assigned
        from the connection counter when absent)."""
        if "id" not in msg:
            msg["id"] = self.next_id()
        with self.lock:
            self._pending[msg["id"]] = meta
        self.sock.sendall(encode(msg))

    def request(self, msg: dict, timeout: float = 30.0) -> dict:
        """Synchronous op (ping/stats/slow): send and wait for its ack."""
        box = _SyncBox()
        self.send(msg, meta=box)
        if not box.event.wait(timeout):
            raise TimeoutError(f"op {msg.get('op')!r} not answered in {timeout}s")
        return box.msg

    def _read(self) -> None:
        try:
            for raw in self._f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    msg = decode(raw)
                except BadRequest:
                    continue  # a garbled line never kills the reader
                with self.lock:
                    meta = self._pending.pop(msg.get("id"), None)
                if isinstance(meta, _SyncBox):
                    meta.msg = msg
                    meta.event.set()
                    continue
                if self._on_response is not None and self._on_response(msg, meta):
                    continue
                with self.lock:
                    self.responses[msg.get("id")] = msg
        except (OSError, ValueError):
            pass

    def inflight(self) -> int:
        with self.lock:
            return len(self._pending)

    def wait_answered(self, ids, timeout: float) -> set:
        """Block until every id in ``ids`` has a stored response (default
        routing); returns the ids still missing at the deadline."""
        deadline = time.monotonic() + timeout
        missing = set(ids)
        while missing and time.monotonic() < deadline:
            with self.lock:
                missing = {i for i in missing if i not in self.responses}
            if missing:
                time.sleep(0.05)
        return missing

    def drain_inflight(self, timeout: float) -> int:
        """Wait for the pending map to empty; returns what's left."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and self.inflight():
            time.sleep(0.01)
        return self.inflight()

    def close(self) -> None:
        import socket as _socket

        # shutdown() before close(): the makefile in _f holds an io ref,
        # so close() alone defers the real fd close and the reader's
        # readline never sees EOF — shutdown delivers it immediately.
        try:
            self.sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass  # peer already hung up
        try:
            self.sock.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)
        try:
            self._f.close()
        except OSError:
            pass


class WireRefused(RuntimeError):
    """The front end would not grant the binary DATA wire (server pinned
    to jsonl, or affinity off).  Carries the hello ack so a caller can
    fall back to JSONL without a second round trip."""

    def __init__(self, ack: dict):
        super().__init__(
            f"binary wire refused: wire={ack.get('wire')!r} "
            f"affinity={ack.get('affinity')!r}"
        )
        self.ack = ack


def _hello(host: str, port: int, timeout: float) -> dict:
    """One-shot JSONL hello to the front end: wire negotiation +
    replica placement.  Its own short-lived socket so the data path
    never shares a connection with ops."""
    import socket as _socket

    sock = _socket.create_connection((host, port), timeout=timeout)
    try:
        sock.sendall(encode({"id": 1, "op": "hello", "wire": "binary"}))
        line = sock.makefile("rb").readline()
    finally:
        try:
            sock.close()
        except OSError:
            pass
    if not line:
        raise OSError("front end closed the connection during hello")
    return decode(line.strip())


class _Frame:
    """One in-flight REQUEST frame: the packed bytes (kept so failover
    can resend it verbatim), its row ids, and the retry latch."""

    __slots__ = ("data", "req_ids", "unanswered", "retried")

    def __init__(self, data: bytes, req_ids):
        self.data = data
        self.req_ids = [int(r) for r in req_ids]
        self.unanswered = set(self.req_ids)
        self.retried = False


class FrameConnection:
    """Binary DATA connection pinned to one replica (affinity).

    Hellos the FRONT END for placement, then connects straight to the
    assigned replica's port and hellos IT (the JSONL ack carries
    ``max_frame_rows``/``max_nnz``/``fields``); everything after that
    ack is frames.  The replica answers directly — the router is out of
    the score path.

    Failover is client-driven, retry-once-on-peer: when the pinned
    replica dies mid-flight (reader EOF/error with frames pending), the
    client re-hellos the front end for a peer and resends each pending
    frame EXACTLY once; a frame whose retry also dies resolves its
    unanswered rows ``unavailable`` locally — never a hang, never a
    third replica.  Answers dedup first-wins, so a frame whose response
    was torn mid-write re-scores harmlessly (same checkpoint + same
    per-bucket programs on every replica ⇒ bit-identical scores).

    Raises ``WireRefused`` when the tier won't grant binary+affinity —
    callers fall back to ``ServeConnection`` JSONL."""

    def __init__(
        self,
        port: int,
        host: str = "127.0.0.1",
        timeout: float = 60.0,
        on_result=None,
    ):
        self.host = host
        self.frontend_port = int(port)
        self.timeout = float(timeout)
        # on_result(req_id, status, score) fires once per row on its FIRST
        # resolution (reader thread, lock held — must be fast and must not
        # call back into this connection).
        self._on_result = on_result
        self.lock = threading.Lock()
        self.results: dict[int, tuple[str, float]] = {}  # req_id -> (status, score)
        self._frames: dict[int, _Frame] = {}  # frame seq -> frame
        self._req2seq: dict[int, int] = {}
        self._seq = 0
        self._closing = False
        self._dead = False
        self.last_error: str | None = None
        self.failovers = 0
        ack = _hello(host, port, timeout)
        if not ack.get("ok") or ack.get("wire") != "binary" or "port" not in ack:
            raise WireRefused(ack)
        self._attach(int(ack["port"]), int(ack.get("replica", -1)))
        self._reader = threading.Thread(
            target=self._read, name="frame-reader", daemon=True
        )
        self._reader.start()

    def _attach(self, rport: int, replica: int) -> None:
        """Connect + hello the assigned replica; frames after the ack."""
        import socket as _socket

        sock = _socket.create_connection((self.host, rport), timeout=self.timeout)
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        rf = sock.makefile("rb")
        sock.sendall(encode({"id": 0, "op": "hello", "wire": "binary"}))
        ack = decode(rf.readline().strip())
        if ack.get("wire") != "binary":
            sock.close()
            raise WireRefused(ack)
        # Publish the new connection under the lock: send_packed reads
        # self.sock there, and a failover re-attach must never hand a
        # sender the half-swapped state.
        with self.lock:
            self.replica = replica
            self.replica_port = rport
            self.max_frame_rows = int(ack.get("max_frame_rows", 1))
            self.max_nnz = int(ack.get("max_nnz", 0))
            self.uses_fields = bool(ack.get("fields", False))
            self.sock = sock
            self._rf = rf

    def send_packed(self, data: bytes, req_ids) -> None:
        """Send one pre-packed REQUEST frame (a load driver packs outside the
        timed loop); rows resolve into ``results``."""
        with self.lock:
            if self._closing:
                raise OSError("connection closed")
            self._seq += 1
            seq = self._seq
            fr = _Frame(data, req_ids)
            self._frames[seq] = fr
            for r in fr.req_ids:
                self._req2seq[r] = seq
            if self._dead:
                # Failover already gave up; resolve locally, typed.
                self._resolve_unavailable_locked([fr])
                return
            sock = self.sock
        try:
            sock.sendall(data)
        except OSError:
            pass  # reader sees the dead socket; failover resends the frame

    def send_batch(
        self, req_ids, ids, vals, fields=None, deadlines_ms=None, klass: str = ""
    ) -> None:
        """Pack + send one frame.  One class per frame on purpose: the
        engine attributes a block's server-side latency to a single
        class, so mixing classes in a frame would blur the per-class p99
        the SLO gate reads."""
        n = len(req_ids)
        data = pack_request_frame(
            req_ids,
            ids,
            vals,
            fields=fields,
            deadlines_ms=deadlines_ms,
            classes=[klass] * n if klass else None,
        )
        self.send_packed(data, req_ids)

    def _resolve_unavailable_locked(self, frames) -> None:
        for fr in frames:
            for r in list(fr.unanswered):
                if r not in self.results:
                    self.results[r] = ("unavailable", 0.0)
                    if self._on_result is not None:
                        self._on_result(r, "unavailable", 0.0)
            self._retire_locked(fr)

    def _retire_locked(self, fr: _Frame) -> None:
        fr.unanswered.clear()
        for r in fr.req_ids:
            if self._req2seq.get(r) is not None:
                self._req2seq.pop(r, None)
        for seq, f in list(self._frames.items()):
            if f is fr:
                self._frames.pop(seq, None)

    def _on_scores(self, count: int, payload: bytes) -> None:
        req_ids, statuses, scores = unpack_scores_frame(count, payload)
        with self.lock:
            for i in range(count):
                rid = int(req_ids[i])
                if rid not in self.results:  # first answer wins (dedup)
                    st = FRAME_STATUS_CODES[int(statuses[i])]
                    sc = float(scores[i])
                    self.results[rid] = (st, sc)
                    if self._on_result is not None:
                        self._on_result(rid, st, sc)
                seq = self._req2seq.pop(rid, None)
                if seq is not None:
                    fr = self._frames.get(seq)
                    if fr is not None:
                        fr.unanswered.discard(rid)
                        if not fr.unanswered:
                            self._frames.pop(seq, None)

    def _read(self) -> None:
        """Reader loop with inline failover: inner loop reads frames off
        the current replica; when it dies the OUTER loop re-pins."""
        while True:
            fatal = None
            try:
                while True:
                    fr = read_frame(self._rf)
                    if fr is None:
                        break  # replica gone (EOF)
                    kind, _flags, count, _width, payload = fr
                    if kind == FRAME_KIND_SCORES:
                        self._on_scores(count, payload)
                    elif kind == FRAME_KIND_ERROR:
                        # The replica lost framing on OUR bytes — the
                        # connection is untrustworthy; fail over.
                        code, detail = unpack_error_frame(payload)
                        fatal = f"{code}: {detail}"
                        break
            except (BadRequest, OSError, ValueError) as e:
                fatal = repr(e)  # torn read — treat as a dead connection
            if fatal:
                self.last_error = fatal
            try:
                self.sock.close()
            except OSError:
                pass
            with self.lock:
                if self._closing:
                    return
                pending = list(self._frames.values())
                retry = [f for f in pending if not f.retried]
                spent = [f for f in pending if f.retried]
                # Second death for these frames: unavailable, locally.
                self._resolve_unavailable_locked(spent)
            if not self._failover(retry):
                return

    def _failover(self, retry) -> bool:
        """Re-hello the front end, pin a peer, resend ``retry`` frames
        once.  False = no peer (or handshake died): resolve + stop."""
        try:
            ack = _hello(self.host, self.frontend_port, self.timeout)
            if not ack.get("ok") or ack.get("wire") != "binary" or "port" not in ack:
                raise OSError(f"re-hello refused: {ack}")
            self._attach(int(ack["port"]), int(ack.get("replica", -1)))
        except (OSError, ValueError, BadRequest, WireRefused) as e:
            self.last_error = repr(e)
            with self.lock:
                self._dead = True
                self._resolve_unavailable_locked(list(self._frames.values()))
            return False
        self.failovers += 1
        with self.lock:
            for fr in retry:
                fr.retried = True
            sock = self.sock
        for fr in retry:
            try:
                sock.sendall(fr.data)
            except OSError:
                break  # the NEW replica died too; next loop pass handles it
        return True

    def answered(self) -> int:
        with self.lock:
            return len(self.results)

    def inflight(self) -> int:
        with self.lock:
            return sum(len(f.unanswered) for f in self._frames.values())

    def wait_answered(self, ids, timeout: float) -> set:
        """Block until every req_id in ``ids`` has a result; returns the
        ids still missing at the deadline (never raises — a missing id
        is the caller's `unanswered` accounting)."""
        deadline = time.monotonic() + timeout
        missing = set(int(i) for i in ids)
        while missing and time.monotonic() < deadline:
            with self.lock:
                missing = {i for i in missing if i not in self.results}
            if missing:
                time.sleep(0.02)
        return missing

    def close(self) -> None:
        import socket as _socket

        with self.lock:
            self._closing = True
        try:
            self.sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)


def spawn_serve(
    cfg_path: str,
    *,
    port: int = 0,
    device: str | None = None,
    timeout_s: float = 300.0,
    log=None,
) -> tuple[subprocess.Popen, int]:
    """Launch ``python -m fast_tffm_tpu_torch.cli serve <cfg> --port N
    [--device D]`` and block until its SERVE_READY line (the deadline
    bounds SILENCE: a child wedged before its first output fails at the
    deadline, not never); returns (proc, announced port).  The caller owns
    terminate()."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "fast_tffm_tpu_torch.cli", "serve", cfg_path,
           "--port", str(port)]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.Popen(
        cmd,
        stdout=subprocess.PIPE,
        stderr=None,
        text=True,
        env=env,
        cwd=_REPO,
    )
    ready = threading.Event()
    box: list[int | None] = [None]

    def wait_ready():
        try:
            for line in proc.stdout:
                line = line.strip()
                if line.startswith(SERVE_READY_PREFIX):
                    fields = dict(
                        kv.split("=", 1)
                        for kv in line[len(SERVE_READY_PREFIX):].split()
                    )
                    box[0] = int(fields["port"])
                    ready.set()
                    break
                if line and log is not None:
                    log(line)
            # After readiness (or EOF), keep draining so the pipe never
            # fills and blocks the server.
            for line in proc.stdout:
                if line.strip() and log is not None:
                    log(line.strip())
        except Exception as e:
            # ANY failure (torn SERVE_READY line, raising log callback)
            # must still reach ready.set() — a dead waiter would turn a
            # fast loud failure into a full spawn-timeout hang, and a
            # dead drain would let the child block on a full pipe.
            log_quietly(log, f"serve ready-waiter error: {e!r}")
        ready.set()

    threading.Thread(target=wait_ready, name="serve-ready", daemon=True).start()
    ready.wait(timeout_s)
    if box[0] is None:
        proc.kill()
        raise RuntimeError(
            f"spawned front end never announced SERVE_READY within {timeout_s:.0f}s"
        )
    return proc, box[0]
