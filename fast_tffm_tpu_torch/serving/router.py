"""Shared-nothing router: N replica worker processes, health-checked
failover.

The port's counterpart of ``fast_tffm_tpu/serving/router.py``::

    clients ─ frontend.py ─► Router ─┬─► replica 0 (worker process)
                                     ├─► replica 1
                                     └─► replica N-1

Each replica is a separate PROCESS (serving/replica.py) with its own CUDA
context, table copy, admission queue and telemetry monitor, so one
replica's death or wedge cannot touch its peers.  The router owns
everything across replicas:

  * **Routing**: round-robin over healthy replicas, a data and a control
    TCP connection per replica, requests multiplexed by id; ``assign``
    hands an affinity client a replica's own port.
  * **Health**: a checker pings every replica on a cadence; a missed pong
    or a wedge (an unanswered score older than ``wedge_timeout_s`` while
    the replica reports no flush for as long) declares it down, and a
    wedged one is SIGKILLed.
  * **Failover**: every request in flight on a dead replica is retried
    ONCE on a healthy peer (the same checkpoint and bucket shapes score
    the same) or failed with a typed ``unavailable``; nothing waits on a
    corpse.
  * **Restart**: bounded relaunches under ``resilience.RestartPolicy``
    with exponential backoff; every death emits ``kind=fault`` and every
    recovery ``kind=restart`` with the measured MTTR (death detected →
    replica answering again).
  * **Reload fan-out**: ONE checkpoint watcher for the tier polls
    ``model_file``'s signature and sends one ``reload`` to every replica
    per observed write, so each delta is applied once per replica.

The router touches no device: the replicas own the cards.
"""

from __future__ import annotations

import itertools
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from fast_tffm_tpu_torch.checkpoint import checkpoint_signature, read_publish_time
from fast_tffm_tpu_torch.resilience import RestartPolicy
from fast_tffm_tpu_torch.serving.metrics import LatencyHistogram
from fast_tffm_tpu_torch.serving.protocol import (
    REPLICA_READY_PREFIX as _READY_PREFIX,
    BadRequest,
    Unavailable,
    WireError,
    decode,
    encode,
)
from fast_tffm_tpu_torch.telemetry import RunMonitor, log_quietly

__all__ = ["Router", "ReplicaProcess", "spawn_replica"]


class ReplicaProcess:
    """Handle for one spawned replica worker: the Popen, its announced
    port, and liveness/kill.  Tests substitute a duck-typed fake (a
    thread-backed socket server) via Router(launcher=...)."""

    def __init__(self, proc: subprocess.Popen, port: int, pid: int):
        self.proc = proc
        self.port = port
        self.pid = pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def returncode(self):
        return self.proc.poll()

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:
            pass

    def wait(self, timeout: float | None = None) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


def spawn_replica(
    config_path: str,
    index: int,
    *,
    run_id: str = "",
    metrics_path: str | None = None,
    device: str | None = None,
    env: dict | None = None,
    log=print,
    ready_timeout_s: float = 180.0,
) -> ReplicaProcess:
    """Default launcher: start ``python -m fast_tffm_tpu_torch.serving.replica``
    (``--device`` passed on: a replica never picks its own device) and
    block until its REPLICA_READY line (the buckets are warm: a replica is
    never routed to cold).  stderr passes through; stdout is drained to
    ``log`` after the readiness line."""
    cmd = [
        sys.executable, "-m", "fast_tffm_tpu_torch.serving.replica",
        config_path, "--replica", str(index), "--port", "0",
    ]
    if device is not None:
        cmd += ["--device", str(device)]
    if run_id:
        cmd += ["--run-id", run_id]
    if metrics_path is not None:
        cmd += ["--metrics-path", metrics_path]
    child_env = dict(os.environ if env is None else env)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = (
        pkg_root + os.pathsep + child_env["PYTHONPATH"]
        if child_env.get("PYTHONPATH")
        else pkg_root
    )
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=None, text=True, env=child_env
    )
    # Readiness wait on a SIDE thread: a child wedged before its first
    # stdout line would park a plain readline forever — the deadline must
    # bound silence, not just the gaps between lines.
    ready = threading.Event()
    port_box: list[int | None] = [None]

    def wait_ready():
        try:
            for line in proc.stdout:
                line = line.strip()
                if line.startswith(_READY_PREFIX):
                    fields = dict(
                        kv.split("=", 1)
                        for kv in line[len(_READY_PREFIX):].split()
                    )
                    port_box[0] = int(fields["port"])
                    ready.set()
                    return
                if line:
                    log(f"replica {index}: {line}")
        except Exception as e:
            # ANY failure (torn READY line, raising log callback) must
            # still reach ready.set() below — a dead waiter otherwise
            # turns a fast loud failure into a full ready-timeout hang.
            log_quietly(log, f"replica {index}: ready-waiter error: {e!r}")
        ready.set()  # EOF / error: unblock the waiter to fail loudly

    waiter = threading.Thread(
        target=wait_ready, name=f"replica-{index}-ready", daemon=True
    )
    waiter.start()
    ready.wait(ready_timeout_s)
    port = port_box[0]
    if port is None:
        proc.kill()
        raise Unavailable(
            f"replica {index} never announced readiness within "
            f"{ready_timeout_s:.0f}s (rc={proc.poll()}) — see its stderr above"
        )

    def drain():  # keep the pipe from filling after READY
        try:
            for line in proc.stdout:
                line = line.rstrip()
                if line:
                    log(f"replica {index}: {line}")
        except Exception as e:
            # the drain exists so the child's stdout pipe can never fill
            # and block it — it must survive even a raising log callback
            log_quietly(log, f"replica {index}: drain error: {e!r}")

    threading.Thread(target=drain, name=f"replica-{index}-drain", daemon=True).start()
    return ReplicaProcess(proc, port, proc.pid)


class _Pending:
    __slots__ = ("msg", "future", "retried", "t0", "kind", "gen")

    def __init__(self, msg, future, kind="score", retried=False, gen=0):
        self.msg = msg
        self.future = future
        self.kind = kind
        self.retried = retried
        self.gen = gen  # reload fan-out ordinal (freshness attribution)
        self.t0 = time.perf_counter()


class _Slot:
    """Per-replica mutable state.  ``state`` ∈ starting | healthy | dead
    | restarting | failed (restart budget spent)."""

    def __init__(self, index: int):
        self.index = index
        self.lock = threading.Lock()  # pending map + writer
        self.handle: ReplicaProcess | None = None
        self.sock: socket.socket | None = None  # data (scores)
        self.ctrl: socket.socket | None = None  # control (ping/reload/...)
        self.state = "starting"
        self.pending: dict[int, _Pending] = {}
        self.requests = 0
        self.restarts = 0
        self.death_t: float | None = None
        self.last_pong_t: float | None = None
        self.ping_outstanding_t: float | None = None
        self.reload_acks = 0
        self.last_reload: dict | None = None

    def inflight(self) -> int:
        with self.lock:
            return len(self.pending)


class Router:
    """See module docstring.  ``launcher(index) -> ReplicaProcess`` (or a
    duck-type) overrides subprocess spawning for tests; ``config_path``
    is required only with the default launcher, which starts each replica
    on ``device`` (None = the replica's default, cuda)."""

    def __init__(
        self,
        cfg,
        *,
        config_path: str | None = None,
        launcher=None,
        run_id: str = "",
        device: str | None = None,
        log=print,
        health_interval_s: float = 0.5,
        ping_timeout_s: float = 2.0,
        wedge_timeout_s: float = 5.0,
        monitor=None,
    ):
        if launcher is None and config_path is None:
            raise ValueError("Router needs config_path (or a custom launcher)")
        self._cfg = cfg
        self._log = log
        self._health_interval = float(health_interval_s)
        self._ping_timeout = float(ping_timeout_s)
        self._wedge_timeout = float(wedge_timeout_s)
        self._policy = RestartPolicy(
            cfg.restart_max, cfg.restart_backoff_s, cfg.restart_backoff_max_s
        )
        if monitor is None:
            monitor = RunMonitor(
                cfg.metrics_path or None, run_id=run_id, source="router", log=log
            )
        self._monitor = monitor
        self.run_id = self._monitor.run_id
        self._launcher = launcher or (
            lambda i: spawn_replica(
                config_path,
                i,
                run_id=self.run_id,
                metrics_path=cfg.metrics_path or None,
                device=device,
                log=self._log,
            )
        )
        self._closed = False
        self._stop = threading.Event()
        # Maintenance threads (assigned after bring-up; close() may run
        # on a bring-up failure before either exists).
        self._health_thread: threading.Thread | None = None
        self._watch_thread: threading.Thread | None = None
        self._next_id = itertools.count(1)
        self._rr = itertools.count()
        # Cross-replica counters (the router's own story for report.py).
        # Reader/health/watch threads and callers all bump these; every
        # += is a read-modify-write, so they share one leaf lock (never
        # held across a call — no ordering edges).
        self._stats_lock = threading.Lock()
        self.failovers = 0  # requests re-sent to a peer after a death
        self.failed_unanswerable = 0  # typed `unavailable` failures
        self.reload_fanouts = 0  # signature changes fanned out
        self.reload_retries = 0  # re-fans after a failed/deferred ack
        self._reload_retry = False  # guarded by _retry_lock: the reader
        #   threads set it, the watch tick swap-reads it — an unlocked
        #   read-then-clear pair could drop the LAST failed ack forever
        self._retry_lock = threading.Lock()
        self.mttr_s: list[float] = []
        # Fleet freshness: per fan-out, the router measures
        # checkpoint-publish → each replica's staged ack (wall clocks on
        # both ends; the engine-side kind=freshness records carry the
        # precise applied/first-scored pair — this is the tier-level
        # roll-up).  One kind=freshness record per COMPLETED fan-out,
        # stamped with the slowest replica's latency; stats() reports the
        # running percentiles operators poll over the wire.
        self._fresh_lock = threading.Lock()
        # Per-replica staged latencies, bounded: the same fixed-bin
        # histogram the engine's freshness pair uses (a raw list would
        # grow one float per ack forever and re-sort under the lock on
        # every stats poll).
        self.freshness_hist = LatencyHistogram()
        self._fanout_gen = 0  # fan-out ordinal: a slow replica's ack from
        #   fan-out N must not be measured against (or close) fan-out N+1
        self._fanout_pub_t: float | None = None
        self._fanout_pending: set[int] = set()
        self._fanout_ms: list[float] = []  # current fan-out only (<= replicas)
        # Reload-watch baseline, captured BEFORE the replicas spawn so a
        # publish landing during their multi-second bring-up still fans
        # out (replicas already on it ack noop — idempotent).
        self._watch_baseline = None
        if cfg.serve_reload_interval_s > 0:
            self._watch_baseline = checkpoint_signature(cfg.model_file)
        self.slots = [_Slot(i) for i in range(max(1, cfg.serve_replicas))]
        # Parallel bring-up: replica warm-up is seconds of torch import,
        # CUDA context and restore; serial would multiply it by N.
        errs: list[BaseException] = []

        def up(slot):
            try:
                self._launch_into(slot)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [
            threading.Thread(
                target=up, args=(s,), name=f"router-up-{s.index}", daemon=True
            )
            for s in self.slots
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs or not self.healthy_replicas():
            self.close()
            raise Unavailable(
                f"router bring-up failed: {errs or 'no replica became healthy'}"
            )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="router-health", daemon=True
        )
        self._health_thread.start()
        self._watch_thread = None
        if cfg.serve_reload_interval_s > 0:
            self._watch_thread = threading.Thread(
                target=self._watch_loop, name="router-reload", daemon=True
            )
            self._watch_thread.start()

    # -- bring-up / connections -------------------------------------------

    def _launch_into(self, slot: _Slot) -> None:
        handle = self._launcher(slot.index)
        # Two connections: DATA carries scores; CONTROL carries
        # ping/reload/slow/stats so health checking never queues behind a
        # score backlog (an overloaded replica must read as overloaded,
        # not dead).
        sock = socket.create_connection(("127.0.0.1", handle.port), timeout=30.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ctrl = socket.create_connection(("127.0.0.1", handle.port), timeout=30.0)
        ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # The 30 s bounds the connect only: a DATA link idle for 30 s (its
        # clients pinned to the replica over frames) is healthy, and the
        # health loop's pings judge liveness.  Left on, the reader's timeout
        # would declare a live replica lost and launch a second one.
        sock.settimeout(None)
        ctrl.settimeout(None)
        with slot.lock:
            # Ghost entries registered into the slot between _on_down's
            # drain and this relaunch (lost races) must not carry over:
            # nothing on the NEW connection will ever answer their ids.
            leftovers = list(slot.pending.values())
            slot.pending.clear()
            slot.handle = handle
            slot.sock = sock
            slot.ctrl = ctrl
            slot.state = "healthy"
            slot.last_pong_t = time.monotonic()
            slot.ping_outstanding_t = None
        for p in leftovers:
            if p.kind == "score":
                self._fail_unanswerable(p)
            elif not p.future.done():
                p.future.set_exception(Unavailable("replica restarted"))
        for s, name in ((sock, "read"), (ctrl, "ctrl")):
            threading.Thread(
                target=self._read_loop,
                args=(slot, s),
                name=f"router-{name}-{slot.index}",
                daemon=True,
            ).start()

    def healthy_replicas(self) -> list[_Slot]:
        return [s for s in self.slots if s.state == "healthy"]

    def assign(self) -> tuple[int, int]:
        """Placement for an affinity-pinned DATA connection:
        pick a healthy replica round-robin and return ``(index, port)``
        — the client connects to the replica DIRECTLY and it answers
        without a router hop.  The router keeps health/reload/placement/
        failover: when the pinned replica dies the client comes back
        here for a peer (its retry-once).  Raises Unavailable when no
        replica is healthy, so the hello gets a typed answer instead of
        a dangling connection."""
        healthy = self.healthy_replicas()
        if not healthy:
            raise Unavailable(
                "no healthy replica to pin (all starting/dead/failed)"
            )
        slot = healthy[next(self._rr) % len(healthy)]
        port = getattr(slot.handle, "port", None)
        if port is None:
            raise Unavailable(f"replica {slot.index} has no port yet")
        return slot.index, int(port)

    # -- submission / routing ---------------------------------------------

    def _send(self, slot: _Slot, obj: dict, ctrl: bool = False) -> None:
        """Whole-line send under the slot lock; raises OSError on a dead
        socket (callers route that into _on_down)."""
        data = encode(obj)
        with slot.lock:
            sock = slot.ctrl if ctrl else slot.sock
            if sock is None:
                raise OSError("replica connection closed")
            sock.sendall(data)

    def _register(self, slot: _Slot, pending: _Pending) -> int:
        req_id = next(self._next_id)
        msg = dict(pending.msg)
        msg["id"] = req_id
        with slot.lock:
            # The msg swap rides the slot lock too: a failover retry
            # re-registers a pending another thread may still observe.
            pending.msg = msg
            slot.pending[req_id] = pending
            slot.requests += 1
        return req_id

    def _dispatch(self, pending: _Pending) -> bool:
        """Send to the next healthy replica; False when none exists (the
        caller fails the future typed)."""
        healthy = self.healthy_replicas()
        if not healthy:
            return False
        slot = healthy[next(self._rr) % len(healthy)]
        req_id = self._register(slot, pending)
        try:
            self._send(slot, pending.msg)
        except OSError as e:
            # The write found the corpse.  _on_down drains slot.pending —
            # but if the slot was ALREADY transitioned (we registered
            # into a dead slot after losing the race with a concurrent
            # _on_down), that drain has run and OUR entry would be
            # stranded forever.  Pull it back out ourselves and give it
            # the same one-retry-or-typed-failure treatment — the
            # no-hung-client invariant must hold against this race too.
            self._on_down(slot, f"send failed: {e}")
            with slot.lock:
                stranded = slot.pending.pop(req_id, None)
            if stranded is not None and not stranded.future.done():
                if stranded.kind != "score" or stranded.retried:
                    self._fail_unanswerable(stranded)
                else:
                    stranded.retried = True
                    with self._stats_lock:
                        self.failovers += 1
                    if not self._dispatch(stranded):
                        self._fail_unanswerable(stranded)
        return True

    def submit(
        self,
        line: str,
        *,
        klass: str = "",
        deadline_ms: float | None = None,
        deadline_at: float | None = None,
    ):
        """Route one request; returns a Future resolving to the float
        score or raising a typed WireError (never hanging on a dead
        replica — failover or a typed failure is guaranteed).
        ``deadline_at`` is an absolute time.monotonic() deadline (same
        host) anchoring the budget at wire receipt; ``deadline_ms`` is
        relative to engine admission."""
        from concurrent.futures import Future

        fut = Future()
        if self._closed:
            fut.set_exception(Unavailable("router is closed"))
            return fut
        msg: dict = {"line": line}
        if klass:
            msg["class"] = klass
        if deadline_ms is not None:
            msg["deadline_ms"] = deadline_ms
        if deadline_at is not None:
            msg["deadline_at"] = deadline_at
        if not self._dispatch(_Pending(msg, fut)):
            with self._stats_lock:
                self.failed_unanswerable += 1
            fut.set_exception(Unavailable("no healthy replica"))
        return fut

    def admin(self, replica: int, op: str, timeout: float = 10.0, **fields) -> dict:
        """Send one op (ping/stats/slow/reload) to replica ``replica``
        and wait for its ack: the latency-injection and introspection side door."""
        from concurrent.futures import Future

        slot = self.slots[replica]
        if slot.state != "healthy":
            raise Unavailable(f"replica {replica} is {slot.state}")
        pending = _Pending({"op": op, **fields}, Future(), kind=op)
        req_id = self._register(slot, pending)
        try:
            self._send(slot, pending.msg, ctrl=True)
        except OSError as e:
            # Same register-into-a-just-died-slot race _dispatch handles:
            # _on_down's drain may have run BEFORE our register, so pull
            # our own entry back out and fail typed instead of letting
            # the caller block out its timeout on a ghost.
            self._on_down(slot, f"send failed: {e}")
            with slot.lock:
                slot.pending.pop(req_id, None)
            if not pending.future.done():
                pending.future.set_exception(
                    Unavailable(f"replica {replica} died during {op}")
                )
        return pending.future.result(timeout=timeout)

    # -- responses ---------------------------------------------------------

    def _read_loop(self, slot: _Slot, sock: socket.socket) -> None:
        try:
            buf = sock.makefile("rb")
            for line in buf:
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = decode(line)
                except BadRequest:
                    continue  # a garbled line never kills the link
                self._on_response(slot, msg)
        except (OSError, ValueError):
            pass
        # EOF/error: if this socket is still one of the slot's current
        # pair, the replica died under us (a restart swaps both first).
        with slot.lock:
            current = sock in (slot.sock, slot.ctrl)
        if current and not self._stop.is_set():
            self._on_down(slot, "connection lost")

    def _on_response(self, slot: _Slot, msg: dict) -> None:
        req_id = msg.get("id")
        with slot.lock:
            pending = slot.pending.pop(req_id, None)
        if pending is None:
            return
        if pending.kind == "ping":
            now = time.monotonic()
            with slot.lock:
                slot.last_pong_t = now
                slot.ping_outstanding_t = None
            pending.future.set_result(msg)
            # A wedged collector is a failure the socket-level checks can
            # never see.  The signal is a CONJUNCTION: the router holds
            # an unanswered score request older than the wedge budget
            # (covers work the collector already popped off the queue —
            # the engine's own oldest_wait_s goes blind there) AND the
            # replica reports no flush completing for that long.  Either
            # alone false-fires: pending age exceeds the budget under
            # deep-backlog overload (flushes still completing), flush age
            # exceeds it on any idle→burst transition (the new request
            # just arrived).  Together they only name a stuck engine.
            age = msg.get("last_flush_age_s")
            if (
                slot.state == "healthy"
                and isinstance(age, (int, float))
                and age > self._wedge_timeout
            ):
                now_pc = time.perf_counter()
                with slot.lock:
                    oldest = min(
                        (
                            p.t0
                            for p in slot.pending.values()
                            if p.kind == "score"
                        ),
                        default=None,
                    )
                if oldest is not None and now_pc - oldest > self._wedge_timeout:
                    self._declare_wedged(
                        slot,
                        min(age, now_pc - oldest),
                        what="no flush while scores wait",
                    )
            return
        if pending.kind == "reload":
            with slot.lock:
                slot.reload_acks += 1
                slot.last_reload = msg
            pending.future.set_result(msg)
            if msg.get("status") in ("staged", "staged_delta"):
                self._note_reload_staged(slot, msg, pending.gen)
            if msg.get("status") in ("failed", "busy"):
                # The replica could not complete this reload (torn write
                # mid-read, or a previous stage unswapped).  Its own
                # polling watcher is OFF in router mode, so the ROUTER
                # must re-drive it: flag a retry fan-out for the next
                # watcher tick (engine-side failure backoff still governs
                # the actual reload attempt rate).
                with self._retry_lock:
                    self._reload_retry = True
            return
        if "score" in msg:
            pending.future.set_result(float(msg["score"]))
        elif msg.get("ok"):
            pending.future.set_result(msg)
        else:
            code = msg.get("code", "unavailable")
            err = WireError(msg.get("error", code))
            err.code = code if code in ("overloaded", "deadline", "bad_request") else "unavailable"
            pending.future.set_exception(err)

    def _note_reload_staged(self, slot: _Slot, msg: dict, pending_gen: int = 0) -> None:
        """One replica staged the fanned-out checkpoint: record its
        publish→staged latency; when the whole fleet has, emit ONE
        aggregate kind=freshness record (the slowest replica's latency is
        the tier's — a client can land anywhere).  Reader threads call
        this concurrently; the lock owns all fan-out state."""
        ms = None
        fleet_done = False
        publish_step = msg.get("step")
        with self._fresh_lock:
            if self._fanout_pub_t is None or pending_gen != self._fanout_gen:
                # No stamp, pre-baseline reload, or a STALE ack: a slow
                # replica still staging fan-out N while fan-out N+1 opened
                # must not be measured against N+1's publish time (nor
                # shrink N+1's pending set).
                return
            ms = max(0.0, (time.time() - self._fanout_pub_t) * 1e3)
            self.freshness_hist.add(ms / 1e3)  # histogram takes seconds
            self._fanout_ms.append(ms)
            self._fanout_pending.discard(slot.index)
            if not self._fanout_pending:
                fleet_done = True
                worst = max(self._fanout_ms)
                n = len(self._fanout_ms)
                self._fanout_pub_t = None
                self._fanout_ms = []
        if fleet_done:
            try:
                self._monitor.emit(
                    "freshness",
                    publish_step=publish_step,
                    publish_to_applied_ms=round(worst, 3),
                    publish_to_first_scored_ms=None,
                    replicas=n,
                    scope="fleet_staged",
                )
            except (OSError, ValueError):
                pass  # lost freshness record, never a dead watcher

    def freshness_percentiles(self) -> dict:
        """Running publish→staged percentiles across every ack observed —
        the fleet freshness number the `stats` wire op reports (the same
        {count, mean, p50, p95, p99, max}-in-ms snapshot vocabulary every
        serving histogram speaks)."""
        with self._fresh_lock:
            return self.freshness_hist.snapshot()

    # -- failure handling --------------------------------------------------

    def _declare_wedged(
        self, slot: _Slot, age: float, what: str = "unanswered ping"
    ) -> None:
        self._log(
            f"router: replica {slot.index} wedged ({what} "
            f"{age:.2f}s > budget) — killing it"
        )
        try:
            self._monitor.emit(
                "fault", event="replica_wedged", replica=slot.index,
                age_s=round(float(age), 3), wedge_signal=what,
            )
        except (OSError, ValueError):
            pass  # lost fault record, never a skipped kill
        # SIGKILL, then the down path (triggered by the socket dropping
        # or directly here) drains and restarts.
        if slot.handle is not None:
            slot.handle.kill()
        self._on_down(slot, "wedged (killed by health check)")

    def _on_down(self, slot: _Slot, why: str) -> None:
        """Replica died: fail over its in-flight requests and start the
        bounded-backoff restart.  Idempotent per incident."""
        with slot.lock:
            if slot.state in ("dead", "restarting", "failed"):
                return
            slot.state = "dead"
            slot.death_t = time.monotonic()
            sock, slot.sock = slot.sock, None
            ctrl, slot.ctrl = slot.ctrl, None
            orphans = list(slot.pending.values())
            slot.pending.clear()
        if slot.handle is not None and slot.handle.alive():
            # A replica the router has stopped talking to is killed before
            # its slot restarts: never two processes for one index, and
            # none outliving the front end.
            slot.handle.kill()
        for s in (sock, ctrl):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        rc = slot.handle.returncode if slot.handle is not None else None
        self._log(f"router: replica {slot.index} down ({why}, rc={rc})")
        try:
            self._monitor.emit(
                "fault", event="replica_crash", replica=slot.index,
                exit_code=rc, detail=why,
            )
        except (OSError, ValueError):
            pass  # lost fault record, never a skipped drain
        # Drain around the corpse: one retry on a healthy peer, else a
        # typed failure — nothing hangs, nothing silently drops.
        for pending in orphans:
            if pending.future.done():
                continue
            if pending.kind != "score" or pending.retried:
                self._fail_unanswerable(pending)
                continue
            pending.retried = True
            with self._stats_lock:
                self.failovers += 1
            if not self._dispatch(pending):
                self._fail_unanswerable(pending)
        if not self._stop.is_set():
            threading.Thread(
                target=self._restart_loop,
                args=(slot,),
                name=f"router-restart-{slot.index}",
                daemon=True,
            ).start()

    def _fail_unanswerable(self, pending: _Pending) -> None:
        with self._stats_lock:
            self.failed_unanswerable += 1
        if not pending.future.done():
            pending.future.set_exception(
                Unavailable("replica died mid-flight and no healthy peer could retry")
            )

    def _restart_loop(self, slot: _Slot) -> None:
        with slot.lock:
            slot.state = "restarting"
        rc = slot.handle.returncode if slot.handle is not None else None
        while not self._stop.is_set():
            with slot.lock:
                slot.restarts += 1
                attempt = slot.restarts
            backoff = self._policy.backoff(attempt)
            if backoff is None:
                with slot.lock:
                    slot.state = "failed"
                self._log(
                    f"router: giving up on replica {slot.index} after "
                    f"{attempt - 1} restart(s) (restart_max "
                    f"= {self._policy.max_restarts})"
                )
                try:
                    self._monitor.emit(
                        "fault", event="replica_giveup", replica=slot.index,
                        attempts=attempt - 1,
                    )
                except (OSError, ValueError):
                    pass  # lost fault record; the giveup state is already set
                return
            if backoff > 0:
                self._log(
                    f"router: replica {slot.index} restart #{attempt} in {backoff:.1f}s"
                )
                if self._stop.wait(backoff):
                    return
            try:
                self._launch_into(slot)
            except Exception as e:
                self._log(f"router: replica {slot.index} relaunch failed: {e!r}")
                continue
            mttr = None
            if slot.death_t is not None:
                mttr = round(time.monotonic() - slot.death_t, 3)
                with self._stats_lock:
                    self.mttr_s.append(mttr)
            self._log(
                f"router: replica {slot.index} back (restart #{attempt}, "
                f"MTTR {mttr}s)"
            )
            try:
                self._monitor.emit(
                    "restart", attempt=attempt, exit_code=rc,
                    backoff_s=round(backoff, 3), mttr_s=mttr, replica=slot.index,
                )
            except (OSError, ValueError):
                pass  # lost restart record; the replica is back either way
            return

    # -- health ------------------------------------------------------------

    def _health_loop(self) -> None:
        from concurrent.futures import Future

        while not self._stop.wait(self._health_interval):
            now = time.monotonic()
            for slot in self.slots:
                if slot.state != "healthy":
                    continue
                # A process that exited is down no matter what the socket
                # says (SIGKILL often leaves the FIN to the kernel).
                if slot.handle is not None and not slot.handle.alive():
                    self._on_down(slot, "process exited")
                    continue
                with slot.lock:
                    outstanding = slot.ping_outstanding_t
                if outstanding is not None and now - outstanding > self._ping_timeout:
                    self._declare_wedged(slot, now - outstanding)
                    continue
                if outstanding is None:
                    pending = _Pending({"op": "ping"}, Future(), kind="ping")
                    with slot.lock:
                        slot.ping_outstanding_t = now
                    self._register(slot, pending)
                    try:
                        self._send(slot, pending.msg, ctrl=True)
                    except OSError as e:
                        self._on_down(slot, f"ping send failed: {e}")

    # -- reload fan-out ----------------------------------------------------

    def _watch_loop(self) -> None:
        from concurrent.futures import Future

        # The baseline was captured in __init__ BEFORE the replicas were
        # spawned: a checkpoint published during the multi-second
        # bring-up window must read as NEW here (replicas that loaded it
        # at spawn just ack noop), not become an invisible baseline.
        last_sig = self._watch_baseline
        while not self._stop.wait(self._cfg.serve_reload_interval_s):
            sig = checkpoint_signature(self._cfg.model_file)
            with self._retry_lock:
                retry, self._reload_retry = self._reload_retry, False
            if sig is None or (sig == last_sig and not retry):
                continue
            if sig != last_sig:
                last_sig = sig
                with self._stats_lock:
                    self.reload_fanouts += 1
                why = "checkpoint changed"
            else:
                with self._stats_lock:
                    self.reload_retries += 1
                why = "re-driving a failed/deferred reload"
            targets = self.healthy_replicas()
            self._log(
                f"router: {why} — fanning reload to {len(targets)} replica(s)"
            )
            # Fleet freshness window: measure publish → each replica's
            # staged ack against the chain head's publish stamp (None on
            # pre-stamp checkpoints — measurement degrades to absent).
            with self._fresh_lock:
                self._fanout_gen += 1
                gen = self._fanout_gen
                self._fanout_pub_t = read_publish_time(self._cfg.model_file)
                self._fanout_pending = {s.index for s in targets}
                self._fanout_ms = []
            for slot in targets:
                pending = _Pending({"op": "reload"}, Future(), kind="reload", gen=gen)
                self._register(slot, pending)
                try:
                    self._send(slot, pending.msg, ctrl=True)
                except OSError as e:
                    self._on_down(slot, f"reload send failed: {e}")

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        reps = []
        for s in self.slots:
            reps.append(
                {
                    "replica": s.index,
                    "state": s.state,
                    "pid": getattr(s.handle, "pid", None),
                    "port": getattr(s.handle, "port", None),
                    "requests": s.requests,
                    "inflight": s.inflight(),
                    "restarts": s.restarts,
                    "reload_acks": s.reload_acks,
                }
            )
        with self._stats_lock:
            counters = {
                "failovers": self.failovers,
                "failed_unanswerable": self.failed_unanswerable,
                "reload_fanouts": self.reload_fanouts,
                "reload_retries": self.reload_retries,
                "mttr_s": list(self.mttr_s),
            }
        return {
            "run_id": self.run_id,
            "replicas": reps,
            **counters,
            "freshness_staged_ms": self.freshness_percentiles(),
        }

    def stats(self, timeout: float = 10.0) -> dict:
        """Router snapshot + each healthy replica's engine stats (the
        ``stats`` wire op's payload) + the fleet freshness roll-up: the
        router's publish→staged percentiles and, from the engines' own
        histograms, the worst replica's publish→first-scored p99 — the
        end-to-end freshness SLO an operator polls without tailing JSONL."""
        out = self.snapshot()
        engines = {}
        for slot in list(self.healthy_replicas()):
            try:
                engines[str(slot.index)] = self.admin(slot.index, "stats", timeout=timeout)
            except Exception as e:
                engines[str(slot.index)] = {"error": repr(e)}
        out["engines"] = engines
        scored_p99 = [
            h.get("p99")
            for e in engines.values()
            for h in ((e.get("engine") or {}).get("freshness_scored_ms"),)
            if isinstance(h, dict) and isinstance(h.get("p99"), (int, float))
        ]
        out["freshness"] = {
            "staged_ms": out.pop("freshness_staged_ms"),
            "scored_p99_ms_worst_replica": max(scored_p99) if scored_p99 else None,
        }
        return out

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        for slot in self.slots:
            orphans = []
            with slot.lock:
                orphans = list(slot.pending.values())
                slot.pending.clear()
                sock, slot.sock = slot.sock, None
                ctrl, slot.ctrl = slot.ctrl, None
                slot.state = "dead"
            for p in orphans:
                if not p.future.done():
                    p.future.set_exception(Unavailable("router closed"))
            if sock is not None:
                try:
                    sock.sendall(encode({"op": "close"}))
                except OSError:
                    pass
            for s in (sock, ctrl):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
        deadline = time.monotonic() + timeout
        for slot in self.slots:
            h = slot.handle
            if h is None:
                continue
            h.wait(timeout=max(0.1, deadline - time.monotonic()))
            if h.alive():
                h.kill()
                h.wait(timeout=2.0)
        # Bound the maintenance threads' lifetime: _stop is set, so both
        # exit at their next wait() tick — a bounded join keeps close()
        # from returning while they still touch slots/monitor state.
        me = threading.current_thread()
        if self._health_thread is not None and self._health_thread is not me:
            self._health_thread.join(timeout=2.0)
        if self._watch_thread is not None and self._watch_thread is not me:
            self._watch_thread.join(timeout=2.0)
        try:
            fresh = self.freshness_percentiles()
            with self._stats_lock:
                failovers = self.failovers
                unanswerable = self.failed_unanswerable
            self._monitor.close(
                router_failovers=failovers,
                router_unanswerable=unanswerable,
                router_restarts=sum(s.restarts for s in self.slots),
                **(
                    {"router_freshness_staged_p99_ms": fresh["p99"]}
                    if fresh.get("count")
                    else {}
                ),
            )
        except (OSError, ValueError):
            pass  # lost summary record on close
