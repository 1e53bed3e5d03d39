"""Fault-tolerant training: supervised restart, fault injection, rollback
support — the counterpart of ``fast_tffm_tpu/resilience.py`` for one
process.

  * **Supervisor** — relaunches a crashed trainer subprocess with bounded
    retries and exponential backoff (``RestartPolicy``), resuming from the
    latest full+delta checkpoint chain after quarantining a torn chain tail
    (``repair_delta_chain``).  Every crash emits a ``kind=fault`` record and
    every relaunch a ``kind=restart`` record with the measured MTTR (crash
    → the child's first new progress line).  The CLI front end is ``train
    --supervised`` (``cli.py``).  Pod mode (``processes`` > 1, ``dist_train
    --supervised``) supervises every host of one multi-process run: one
    child per host, the generation file, and the relaunch of only the dead
    host while the survivors re-exec in place (``distributed.py``).
  * **FaultPlan / FaultInjector** — a seeded, reproducible fault schedule
    (``kill@N``, ``io_error@N``, ``nan@A[:B]``, ``torn_delta@K``,
    ``kill_publish@K``, …, or ``random:kill=2,...`` drawn from a seed),
    byte for byte the JAX package's (``FaultPlan.to_json``).  Kill faults
    ride the training loop's ``step_hook``, IO faults raise inside the FMB
    reader's retry loop (``data/binary.py``), NaN faults poison the
    host-side loss the loop's finite check reads, torn-delta faults
    truncate a published delta file (``checkpoint_async.py``) and publish
    kills fire between a finished tmp file and its rename
    (``checkpoint.py``).  Every fault is one-shot.  The serving and stream
    kinds are executed by their own programs (a chaos client, a stream
    writer), never by the in-process injector.
  * **The fault event and counter sink** — module-level, so the reader and
    checkpoint threads note retries and faults without a RunMonitor; the
    training loop drains them into ``kind=fault`` records at log points and
    ``fault_*`` counters on the run summary.

The module imports no torch, at import or later: a supervising process
never holds a CUDA context beside its child.  ``repair_delta_chain`` reads
the npz files with numpy alone.
"""

from __future__ import annotations

import glob as _glob_mod
import json
import os
import re
import signal
import statistics
import subprocess
import threading
import time

__all__ = [
    "FAULT_KINDS",
    "SERVING_FAULT_KINDS",
    "STREAM_FAULT_KINDS",
    "FaultPlan",
    "RestartPolicy",
    "FaultInjector",
    "install_faults",
    "active_faults",
    "clear_faults",
    "maybe_io_fault",
    "maybe_torn_delta",
    "maybe_publish_fault",
    "maybe_writeback_fault",
    "note_io_retry",
    "drain_fault_events",
    "drain_fault_counters",
    "NonFiniteLossError",
    "repair_delta_chain",
    "Supervisor",
]


class NonFiniteLossError(RuntimeError):
    """A non-finite training loss, raised before any save.  It carries the
    step, the loss and the input cursor at detection time, so ``on_nan =
    rollback`` can restore the last checkpoint and resume the input at the
    cursor, skipping the window whose data diverged."""

    def __init__(self, message: str, *, step: int = 0, loss=None, cursor=None):
        super().__init__(message)
        self.step = int(step)
        self.loss = loss
        self.cursor = cursor


# ---------------------------------------------------------------------------
# fault event / counter sink
# ---------------------------------------------------------------------------

_sink_lock = threading.Lock()
_EVENTS: list[dict] = []
_COUNTERS: dict[str, int] = {}
_MAX_EVENTS = 256  # bounded: a retry storm must not eat the host's memory


def _record(event: dict) -> None:
    with _sink_lock:
        _COUNTERS[event["event"]] = _COUNTERS.get(event["event"], 0) + 1
        if len(_EVENTS) < _MAX_EVENTS:
            _EVENTS.append(event)


def drain_fault_events() -> list[dict]:
    """Pop all pending fault events (dicts with an ``event`` key and detail
    fields, never ``step``, which the emitter's envelope owns)."""
    with _sink_lock:
        out, _EVENTS[:] = list(_EVENTS), []
        return out


def drain_fault_counters() -> dict[str, int]:
    """Snapshot and clear the per-event counters (run summary fields)."""
    with _sink_lock:
        out = dict(_COUNTERS)
        _COUNTERS.clear()
        return out


def note_io_retry(what: str, exc: Exception, attempt: int = 1) -> None:
    """A transient IO error absorbed by a retry (the FMB reader), recorded
    so the run's telemetry shows the near-miss."""
    _record({"event": "io_retry", "what": what, "error": repr(exc), "attempt": attempt})


# ---------------------------------------------------------------------------
# fault plan / injector
# ---------------------------------------------------------------------------

# The JAX package's tuples, in its order: the seeded grammar draws positions
# in FAULT_KINDS order, so the order is part of every seed's schedule.
FAULT_KINDS = (
    "kill",
    "io_error",
    "nan",
    "torn_delta",
    "kill_publish",
    "replica_kill",
    "replica_slow",
    "reload_corrupt",
    "stream_stall",
    "append_torn",
    "kill_writeback",
)

# What each kind's ``@N`` counts: kill / nan the absolute training step;
# io_error the Nth FMB read operation; torn_delta the Kth delta-file write;
# kill_publish the Kth npz publish (full or delta) — SIGKILL between the
# finished tmp file and the rename; kill_writeback the Kth tiered-store
# writeback apply (paramstore/tiered.py, mid-apply).  The
# serving kinds' ``@N`` is a replica index (0-based): replica_kill,
# replica_slow@N:MS (MS ms of latency a flush), reload_corrupt.
SERVING_FAULT_KINDS = ("replica_kill", "replica_slow", "reload_corrupt")

# Stream kinds, executed by the writer of a followed FMS stream (the
# program that runs ``data/stream.py::StreamWriter``): stream_stall@N
# pauses N seconds; append_torn@K leaves the Kth append's last record half
# written for a while (the reader must wait it out, never parse it).
STREAM_FAULT_KINDS = ("stream_stall", "append_torn")


class FaultPlan:
    """A concrete, ordered fault schedule; the same (spec, seed, horizon)
    gives the same ``to_json`` bytes as the JAX package's."""

    def __init__(self, events: list[dict], *, spec: str = "", seed: int = 0):
        for e in events:
            if e.get("kind") not in FAULT_KINDS:
                raise ValueError(
                    f"unknown fault kind {e.get('kind')!r} (one of {FAULT_KINDS})"
                )
            floor = 0 if e["kind"] in SERVING_FAULT_KINDS else 1
            if int(e.get("at", floor - 1)) < floor:
                raise ValueError(f"fault position must be >= {floor}: {e}")
        self.events = sorted(
            (
                {k: int(v) if k in ("at", "until") else v for k, v in e.items()}
                for e in events
            ),
            key=lambda e: (e["at"], e["kind"]),
        )
        self.spec = spec
        self.seed = int(seed)

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0, horizon: int = 1000) -> "FaultPlan":
        """Two grammars:

        * explicit — ``"kill@120,io_error@45,nan@200:210,torn_delta@1"``
          (``nan@A:B`` poisons the first checked step in [A, B));
        * seeded — ``"random:kill=2,io_error=3,nan=1"`` draws that many
          positions per kind in [1, horizon) from ``random.Random(seed)``
          (per-write kinds in [1, max(2, horizon // 50))).
        """
        import random

        spec = spec.strip()
        if not spec:
            raise ValueError("empty fault plan spec")
        if spec.startswith("random:"):
            rng = random.Random(int(seed))
            counts: dict[str, int] = {}
            for tok in spec[len("random:") :].split(","):
                tok = tok.strip()
                if not tok:
                    continue
                kind, _, n = tok.partition("=")
                kind = kind.strip()
                if kind not in FAULT_KINDS:
                    raise ValueError(
                        f"unknown fault kind {kind!r} in {spec!r} (one of {FAULT_KINDS})"
                    )
                counts[kind] = int(n or 1)
            events = []
            # Fixed kind order: the draws must not depend on the spec's order.
            for kind in FAULT_KINDS:
                for _ in range(counts.get(kind, 0)):
                    if kind in SERVING_FAULT_KINDS:
                        # A replica index of a 2-replica front end;
                        # replica_slow also draws its latency.
                        e = {"kind": kind, "at": rng.randrange(0, 2)}
                        if kind == "replica_slow":
                            e["until"] = rng.randrange(50, 501)
                        events.append(e)
                        continue
                    if kind == "stream_stall":
                        # A pause in seconds.
                        events.append({"kind": kind, "at": rng.randrange(1, 6)})
                        continue
                    hi = (
                        max(2, horizon // 50)
                        if kind in ("torn_delta", "kill_publish", "append_torn",
                                    "kill_writeback")
                        else max(2, horizon)
                    )
                    events.append({"kind": kind, "at": rng.randrange(1, hi)})
            return cls(events, spec=spec, seed=seed)
        events = []
        for tok in spec.split(","):
            tok = tok.strip()
            if not tok:
                continue
            kind, _, pos = tok.partition("@")
            kind = kind.strip()
            if kind not in FAULT_KINDS or not pos:
                raise ValueError(
                    f"bad fault token {tok!r} (want kind@pos, kind one of {FAULT_KINDS})"
                )
            at, _, until = pos.partition(":")
            e = {"kind": kind, "at": int(at)}
            if until:
                if kind == "nan":
                    e["until"] = int(until)
                    if e["until"] <= e["at"]:
                        # An empty window would parse and never fire.
                        raise ValueError(
                            f"empty nan window {tok!r}: until must be > at"
                        )
                elif kind == "replica_slow":
                    e["until"] = int(until)
                    if e["until"] < 1:
                        raise ValueError(
                            f"replica_slow latency must be >= 1 ms: {tok!r}"
                        )
                else:
                    raise ValueError(
                        f"only nan faults take a window (and replica_slow a "
                        f"latency) after ':': {tok!r}"
                    )
            elif kind == "replica_slow":
                raise ValueError(
                    f"replica_slow needs a latency: replica_slow@N:MS, got {tok!r}"
                )
            events.append(e)
        return cls(events, spec=spec, seed=seed)

    def to_json(self) -> str:
        """The canonical serialization (byte-identical to the JAX package's)."""
        return json.dumps(
            {"seed": self.seed, "spec": self.spec, "events": self.events},
            sort_keys=True,
            separators=(",", ":"),
        )

    def serving_events(self) -> list[dict]:
        """The serving-tier faults in schedule order (the in-process
        injector ignores them)."""
        return [e for e in self.events if e["kind"] in SERVING_FAULT_KINDS]

    def stream_events(self) -> list[dict]:
        """The stream-writer faults in schedule order (the in-process
        injector ignores them)."""
        return [e for e in self.events if e["kind"] in STREAM_FAULT_KINDS]


class FaultInjector:
    """Executes a FaultPlan through the runtime's injection points.
    Thread-safe (IO faults fire in the prefetch thread, torn-delta and
    publish faults in the checkpoint writer's, kill and nan in the loop's);
    every fault fires once."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._kills = sorted(e["at"] for e in plan.events if e["kind"] == "kill")
        self._nans = sorted(
            (e["at"], e.get("until", e["at"] + 1)) for e in plan.events if e["kind"] == "nan"
        )
        self._io = {e["at"] for e in plan.events if e["kind"] == "io_error"}
        self._torn = {e["at"] for e in plan.events if e["kind"] == "torn_delta"}
        self._kill_publish = {e["at"] for e in plan.events if e["kind"] == "kill_publish"}
        self._kill_writeback = {e["at"] for e in plan.events if e["kind"] == "kill_writeback"}
        self._io_ops = 0
        self._delta_writes = 0
        self._publishes = 0

    def step_hook(self, step: int) -> None:
        """The training loop's ``step_hook``: SIGKILL the process at the first
        hooked step >= each planned kill (hooks fire K-step aligned)."""
        fire = False
        with self._lock:
            while self._kills and step >= self._kills[0]:
                self._kills.pop(0)
                fire = True
        if fire:
            # No cleanup: the checkpoint chain's crash consistency is the point.
            os.kill(os.getpid(), signal.SIGKILL)

    def nan_due(self, step: int) -> bool:
        """True once, for the first checked step inside a planned nan window
        (the loop then poisons that step's host-side loss)."""
        with self._lock:
            while self._nans:
                at, until = self._nans[0]
                if step >= until:
                    self._nans.pop(0)  # a window the K-step grid stepped over
                    continue
                if step >= at:
                    self._nans.pop(0)
                    _record({"event": "injected_nan", "at": step, "planned_at": at})
                    return True
                return False
        return False

    def on_io_op(self, what: str) -> None:
        """Called per FMB read operation; raises a transient OSError on the
        planned ordinals (the reader's retry absorbs it)."""
        with self._lock:
            self._io_ops += 1
            n = self._io_ops
            due = n in self._io
            if due:
                self._io.discard(n)
        if due:
            _record({"event": "injected_io_error", "op": n, "what": what})
            raise OSError(f"injected transient IO fault (op #{n}, {what})")

    def on_publish(self, path: str) -> None:
        """Called between a finished tmp file and its rename; SIGKILLs the
        process on the Kth publish (the chain head on disk must stay
        restorable)."""
        with self._lock:
            self._publishes += 1
            n = self._publishes
            due = n in self._kill_publish
            if due:
                self._kill_publish.discard(n)
        if due:
            _record({"event": "injected_kill_publish", "publish": n, "path": path})
            os.kill(os.getpid(), signal.SIGKILL)

    def on_writeback_apply(self, ordinal: int) -> None:
        """The tiered store's writeback-apply point
        (``TieredParamServer.apply_pending``, after the first chunk's store
        write, before the boundary is stamped): SIGKILLs on the Kth apply."""
        with self._lock:
            due = ordinal in self._kill_writeback
            if due:
                self._kill_writeback.discard(ordinal)
        if due:
            _record({"event": "injected_kill_writeback", "apply": ordinal})
            os.kill(os.getpid(), signal.SIGKILL)

    def on_delta_write(self, path: str) -> None:
        """Called after each delta-file publish; truncates the Kth one to a
        third (the torn write a crash leaves on a non-atomic filesystem)."""
        with self._lock:
            self._delta_writes += 1
            n = self._delta_writes
            due = n in self._torn
            if due:
                self._torn.discard(n)
        if not due:
            return
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 3))
            _record({"event": "injected_torn_delta", "path": path, "write": n})
        except OSError:
            pass


_active_lock = threading.Lock()
_ACTIVE: FaultInjector | None = None


def install_faults(plan: FaultPlan) -> FaultInjector:
    """Arm ``plan`` process-wide; returns the injector (its ``step_hook``
    is what the CLI passes to ``train``)."""
    global _ACTIVE
    inj = FaultInjector(plan)
    with _active_lock:
        _ACTIVE = inj
    return inj


def active_faults() -> FaultInjector | None:
    return _ACTIVE


def clear_faults() -> None:
    global _ACTIVE
    with _active_lock:
        _ACTIVE = None


def maybe_io_fault(what: str) -> None:
    """The FMB reader's injection point (a no-op unless a plan is armed)."""
    inj = _ACTIVE
    if inj is not None:
        inj.on_io_op(what)


def maybe_torn_delta(path: str) -> None:
    """The delta writer's injection point (a no-op unless a plan is armed)."""
    inj = _ACTIVE
    if inj is not None:
        inj.on_delta_write(path)


def maybe_publish_fault(path: str) -> None:
    """The npz publish's injection point, between the tmp write and the
    rename (a no-op unless a plan is armed)."""
    inj = _ACTIVE
    if inj is not None:
        inj.on_publish(path)


def maybe_writeback_fault(ordinal: int) -> None:
    """The tiered store's writeback-apply injection point (a no-op unless a
    plan is armed)."""
    inj = _ACTIVE
    if inj is not None:
        inj.on_writeback_apply(ordinal)


# ---------------------------------------------------------------------------
# delta-chain repair
# ---------------------------------------------------------------------------

_DELTA_RE = re.compile(r"\.delta-(\d{4})\.npz$")


def _delta_files(path: str) -> list[str]:
    out = []
    for p in _glob_mod.glob(_glob_mod.escape(path) + ".delta-*.npz"):
        m = _DELTA_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


def _npz_str(z, key) -> str | None:
    import numpy as np

    if key not in getattr(z, "files", ()):
        return None
    return bytes(np.asarray(z[key]).tobytes()).decode()


def repair_delta_chain(path: str, log=print) -> list[str]:
    """Quarantine a torn or unchained delta-chain tail so a resume lands on
    the last good link.

    ``restore_checkpoint`` is strict (a torn delta fails, naming the file);
    the Supervisor calls this before each relaunch.  Every delta from the
    first unreadable or unchained link on is renamed ``*.corrupt`` (later
    links chain from the bad one, so none of them can apply); the cursor in
    the last good link keeps the resumed input consistent, and the
    quarantined windows' data trains again.  Returns the quarantined paths
    (empty: the chain is healthy)."""
    import numpy as np

    if not os.path.isfile(path):
        return []
    try:
        with np.load(path, allow_pickle=False) as z:
            expect = _npz_str(z, "save_id")
    # An unreadable base is nothing a tail repair can fix: the strict
    # restore reports it.
    except Exception:
        return []
    deltas = _delta_files(path)
    bad_from, reason = None, ""
    for i, dp in enumerate(deltas):
        try:
            with np.load(dp, allow_pickle=False) as z:
                for name in z.files:  # a full read: the CRC and truncation check
                    np.asarray(z[name])
                parent = _npz_str(z, "parent_sig")
                sid = _npz_str(z, "save_id")
        except Exception as e:
            bad_from, reason = i, f"unreadable ({type(e).__name__})"
            break
        if expect is None or parent != expect:
            bad_from, reason = i, "chain break (parent_sig mismatch)"
            break
        expect = sid
    if bad_from is None:
        return []
    quarantined = []
    for dp in deltas[bad_from:]:
        try:
            os.replace(dp, dp + ".corrupt")
            quarantined.append(dp + ".corrupt")
        except OSError:
            pass
    log(
        f"resilience: quarantined {len(quarantined)} delta file(s) from "
        f"{os.path.basename(deltas[bad_from])!r} on — {reason}; resuming "
        "from the last good chain link"
    )
    _record({"event": "chain_repair", "quarantined": len(quarantined), "reason": reason})
    return quarantined


# ---------------------------------------------------------------------------
# restart policy (the training Supervisor and the serving router)
# ---------------------------------------------------------------------------


class RestartPolicy:
    """Bounded retries + exponential backoff, as data: ``backoff(attempt)``
    returns the pre-relaunch sleep for restart ``attempt`` (1-based), or
    None once the budget is spent (``[Resilience] restart_max``,
    ``restart_backoff_s``, ``restart_backoff_max_s``)."""

    def __init__(self, max_restarts: int, backoff_s: float, backoff_max_s: float):
        self.max_restarts = max(0, int(max_restarts))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)

    def backoff(self, attempt: int) -> float | None:
        if attempt > self.max_restarts:
            return None
        return min(self.backoff_s * (2.0 ** (attempt - 1)), self.backoff_max_s)


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

# Child output lines that count as new training progress: the MTTR clock
# (crash → first new progress) stops at the first match after a relaunch.
# "resumed from" is not one: a finished restore is not yet a new step.
_STEP_RE = re.compile(r"^step (\d+) ")
_POD_HOST = "127.0.0.1"  # the pod's children run on the supervisor's host
_PROGRESS_MARKERS = ("checkpoint ->", "training done:", "stopped on signal")


class Supervisor:
    """Relaunch a crashed trainer with bounded retries and exponential
    backoff.

    ``build_cmd(attempt, resume)`` returns the child argv for launch
    ``attempt`` (0 = first); ``resume`` is True when a checkpoint exists to
    continue from (the caller appends ``--resume``).  The child's stdout,
    with its stderr merged in, is read line by line (the port's trainer
    logs to stderr) and passed to ``child_log``.  Telemetry goes to
    ``metrics_path`` through a RunMonitor with ``source="supervisor"``:
    one ``kind=fault`` (event crash) per child death, one ``kind=restart``
    per relaunch with the backoff and the measured MTTR, and a closing
    summary with the restart count and the MTTR median.  Returns the
    child's last exit code (0 on eventual success).

    **Pod mode** (``processes`` N > 1): the supervisor runs all N hosts of
    one multi-process ``dist_train``.  ``build_cmd(attempt, resume,
    process_index)`` takes the child's process index, the children get the
    ``FM_DIST_*`` environment contract (``distributed.py``), and the
    supervisor owns the pod's generation file under ``runtime_dir``: when
    one child dies only that child is relaunched, the generation is bumped
    with a fresh coordinator port (``127.0.0.1:<free port>``: the pod runs
    on this host), the survivors' watchers re-exec them in place, and the
    whole pod meets again, restores the shared chain head and resumes at the cursor vector.
    ``kind=fault`` and ``kind=restart`` records carry the child's
    ``process``; restarts and backoff count per incident.  A crash after
    part of the pod finished cannot re-form the pod and gives up.
    ``straggler_timeout_s`` > 0 also SIGKILLs a child whose heartbeat,
    written since its launch, goes stale (a wedged host), which then takes
    the relaunch path."""

    def __init__(
        self,
        build_cmd,
        *,
        model_file: str,
        max_restarts: int = 5,
        backoff_s: float = 1.0,
        backoff_max_s: float = 30.0,
        metrics_path: str | None = None,
        run_id: str = "",
        log=print,
        child_log=None,
        sleep=time.sleep,
        repair: bool = True,
        env: dict | None = None,
        processes: int = 1,
        runtime_dir: str | None = None,
        straggler_timeout_s: float = 0.0,
    ):
        self._build_cmd = build_cmd
        self._model_file = model_file
        self._policy = RestartPolicy(max_restarts, backoff_s, backoff_max_s)
        self._metrics_path = metrics_path
        self._run_id = run_id
        self._log = log
        self._child_log = child_log
        self._sleep = sleep
        self._repair = repair
        self._env = env
        self._processes = max(1, int(processes))
        self._runtime_dir = runtime_dir
        self._straggler_timeout_s = float(straggler_timeout_s)
        if self._processes > 1 and not runtime_dir:
            raise ValueError("pod mode (processes > 1) requires runtime_dir")
        self.restarts = 0
        self.mttr_s: list[float] = []
        self.last_rc: int | None = None

    def _tail(self, proc, first_progress_t, last_step, on_progress=None) -> None:
        from fast_tffm_tpu_torch.telemetry import log_quietly

        try:
            for line in proc.stdout:
                line = line.rstrip("\n")
                m = _STEP_RE.match(line)
                if m:
                    last_step[0] = int(m.group(1))
                if first_progress_t[0] is None and (
                    m or any(p in line for p in _PROGRESS_MARKERS)
                ):
                    first_progress_t[0] = time.monotonic()
                    if on_progress is not None:
                        try:
                            on_progress()
                        # The tail thread outlives any callback bug (the MTTR
                        # is already stamped).
                        except Exception:
                            pass
                log_quietly(self._child_log, line)
        except (OSError, ValueError):
            pass  # a pipe closed by the kill

    def run(self, resume: bool = False) -> int:
        if self._processes > 1:
            return self._run_pod(resume=resume)
        from fast_tffm_tpu_torch.telemetry import RunMonitor

        monitor = RunMonitor(
            self._metrics_path, run_id=self._run_id, source="supervisor", log=self._log,
        )
        attempt = 0
        crash_t = None
        prev_rc = None
        used_backoff = 0.0
        try:
            while True:
                do_resume = resume if attempt == 0 else os.path.exists(self._model_file)
                cmd = self._build_cmd(attempt, do_resume)
                self._log(
                    f"supervisor: launch attempt {attempt}"
                    f"{' (resume)' if do_resume else ''}: {' '.join(cmd)}"
                )
                first_progress_t = [None]
                last_step = [0]
                # The restart record goes out the moment the relaunched child
                # makes progress (a recovered trainer may run for days); a
                # child that dies again first gets it post mortem, mttr_s null.
                restart_lock = threading.Lock()
                restart_emitted = [False]

                def emit_restart(attempt=attempt, prev_rc=prev_rc,
                                 backoff=used_backoff, crash_t=crash_t):
                    with restart_lock:
                        if restart_emitted[0]:
                            return
                        restart_emitted[0] = True
                    # MTTR: the crash → this child's first progress, the
                    # backoff included (recovery time the run pays).
                    mttr = None
                    if first_progress_t[0] is not None and crash_t is not None:
                        mttr = round(first_progress_t[0] - crash_t, 3)
                        self.mttr_s.append(mttr)
                    monitor.emit(
                        "restart",
                        step=last_step[0],
                        attempt=attempt,
                        exit_code=prev_rc,
                        backoff_s=round(backoff, 3),
                        mttr_s=mttr,
                    )

                proc = subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                    env=self._env,
                )
                reader = threading.Thread(
                    target=self._tail,
                    args=(proc, first_progress_t, last_step,
                          emit_restart if attempt > 0 else None),
                    name="supervisor-tail",
                    daemon=True,
                )
                reader.start()
                rc = proc.wait()
                reader.join(timeout=10.0)
                self.last_rc = rc
                if attempt > 0:
                    emit_restart()  # a no-op when the first progress sent it
                if rc == 0:
                    self._log(
                        f"supervisor: trainer completed cleanly after {attempt} restart(s)"
                    )
                    return 0
                crash_t = time.monotonic()
                sig = -rc if rc < 0 else None
                monitor.emit(
                    "fault",
                    step=last_step[0],
                    event="crash",
                    exit_code=rc,
                    signal=sig,
                    attempt=attempt,
                )
                self._log(
                    f"supervisor: trainer died (rc={rc}"
                    + (f", signal {sig}" if sig else "")
                    + f") around step {last_step[0]}"
                )
                used_backoff = self._policy.backoff(attempt + 1)
                if used_backoff is None:
                    self._log(
                        f"supervisor: giving up after {attempt} restart(s) "
                        f"(restart_max = {self._policy.max_restarts})"
                    )
                    return rc
                if self._repair:
                    try:
                        repair_delta_chain(self._model_file, log=self._log)
                    except Exception as e:
                        self._log(f"supervisor: chain repair failed: {e!r}")
                if used_backoff > 0:
                    self._log(f"supervisor: backing off {used_backoff:.1f}s before relaunch")
                    self._sleep(used_backoff)
                prev_rc = rc
                attempt += 1
                self.restarts = attempt
        finally:
            summary: dict = {"supervisor_restarts": self.restarts}
            if self.mttr_s:
                summary["mttr_s_median"] = round(statistics.median(self.mttr_s), 3)
                summary["mttr_s_max"] = round(max(self.mttr_s), 3)
            monitor.close(**summary)

    # -- pod mode ----------------------------------------------------------

    def _clear_heartbeats(self) -> None:
        """Remove the hb-* files, so only this run's heartbeats are judged."""
        for p in range(self._processes):
            try:
                os.remove(os.path.join(self._runtime_dir, f"hb-{p}.json"))
            except OSError:
                pass

    def _pod_launch(self, p: int, attempt: int, resume: bool, generation: int, monitor) -> dict:
        """Start child ``p`` into pod ``generation``; returns its record."""
        from fast_tffm_tpu_torch.distributed import (
            ENV_GENERATION,
            ENV_PROCESS_ID,
            ENV_PROCESSES,
            ENV_RUNTIME_DIR,
        )

        cmd = self._build_cmd(attempt, resume, p)
        env = dict(self._env if self._env is not None else os.environ)
        env[ENV_RUNTIME_DIR] = self._runtime_dir
        env[ENV_PROCESS_ID] = str(p)
        env[ENV_PROCESSES] = str(self._processes)
        env[ENV_GENERATION] = str(generation)
        self._log(
            f"supervisor: launch host {p} attempt {attempt} gen {generation}"
            f"{' (resume)' if resume else ''}: {' '.join(cmd)}"
        )
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, env=env)
        rec = {
            "process": p,
            "proc": proc,
            "attempt": attempt,
            "launched_wall": time.time(),  # the straggler check's grace anchor
            "first_progress_t": [None],
            "last_step": [0],
            "restart_emitted": [False],
            "crash_t": None,  # set by the incident that relaunched it
            "prev_rc": None,
            "backoff": 0.0,
        }

        def emit_restart():
            if rec["attempt"] == 0 or rec["restart_emitted"][0]:
                return
            rec["restart_emitted"][0] = True
            mttr = None
            if rec["first_progress_t"][0] is not None and rec["crash_t"] is not None:
                mttr = round(rec["first_progress_t"][0] - rec["crash_t"], 3)
                self.mttr_s.append(mttr)
            monitor.emit(
                "restart",
                step=rec["last_step"][0],
                attempt=rec["attempt"],
                exit_code=rec["prev_rc"],
                backoff_s=round(rec["backoff"], 3),
                mttr_s=mttr,
                process=p,
            )

        rec["emit_restart"] = emit_restart
        tail = threading.Thread(
            target=self._tail,
            args=(proc, rec["first_progress_t"], rec["last_step"],
                  emit_restart if attempt > 0 else None),
            name=f"supervisor-tail-{p}",
            daemon=True,
        )
        tail.start()
        rec["tail"] = tail
        return rec

    def _run_pod(self, resume: bool = False) -> int:
        """Supervise N pod hosts: on a crash, bump the generation (a fresh
        coordinator port: the survivors re-exec in place), repair the chain
        and relaunch only the dead host(s), at most ``max_restarts``
        incidents with exponential backoff.  Returns 0 when every host
        finishes cleanly."""
        from fast_tffm_tpu_torch.distributed import (
            PEER_LOST_EXIT,
            free_port,
            read_heartbeat,
            write_generation,
        )
        from fast_tffm_tpu_torch.telemetry import RunMonitor

        monitor = RunMonitor(
            self._metrics_path, run_id=self._run_id, source="supervisor", log=self._log,
        )
        generation = 0
        attempt = 0  # the incident ordinal (bounded by max_restarts)
        n = self._processes
        # A previous run's stale files must not read as stragglers before
        # the children even start.
        self._clear_heartbeats()
        write_generation(self._runtime_dir, {
            "generation": generation,
            "coordinator": f"{_POD_HOST}:{free_port()}",
            "num_processes": n,
            "cause": "start",
        })
        children = {p: self._pod_launch(p, 0, resume, generation, monitor) for p in range(n)}
        relaunched: list[dict] = []  # every attempt > 0 record, for post mortems
        finished: dict[int, int] = {}
        final_rc = 0
        try:
            while children:
                time.sleep(0.2)
                dead = {p: rec for p, rec in children.items() if rec["proc"].poll() is not None}
                for rec in dead.values():
                    rec["tail"].join(timeout=5.0)
                crashed = {}
                for p, rec in dead.items():
                    rc = rec["proc"].returncode
                    self.last_rc = rc
                    del children[p]
                    if rc == 0:
                        finished[p] = 0
                        self._log(f"supervisor: host {p} completed cleanly")
                    else:
                        crashed[p] = (rec, rc)
                if crashed:
                    crash_t = time.monotonic()
                    for p, (rec, rc) in crashed.items():
                        sig = -rc if rc < 0 else None
                        monitor.emit("fault", step=rec["last_step"][0], event="crash",
                                     exit_code=rc, signal=sig, attempt=attempt, process=p)
                        self._log(
                            f"supervisor: host {p} died (rc={rc}"
                            + (f", signal {sig}" if sig else "")
                            + (" — peer-lost exit" if rc == PEER_LOST_EXIT else "")
                            + f") around step {rec['last_step'][0]}"
                        )
                    if finished:
                        # Part of the pod already finished the run: a relaunch
                        # could never re-form an N-process rendezvous.
                        final_rc = next(rc for _, rc in crashed.values())
                        self._log("supervisor: crash after other hosts finished — "
                                  "cannot re-form the pod; giving up")
                        break
                    backoff = self._policy.backoff(attempt + 1)
                    if backoff is None:
                        final_rc = next(rc for _, rc in crashed.values())
                        self._log(
                            f"supervisor: giving up after {attempt} restart incident(s) "
                            f"(restart_max = {self._policy.max_restarts})"
                        )
                        break
                    attempt += 1
                    self.restarts = attempt
                    if self._repair:
                        try:
                            repair_delta_chain(self._model_file, log=self._log)
                        except Exception as e:
                            self._log(f"supervisor: chain repair failed: {e!r}")
                    generation += 1
                    write_generation(self._runtime_dir, {
                        "generation": generation,
                        "coordinator": f"{_POD_HOST}:{free_port()}",
                        "num_processes": n,
                        "cause": f"host {sorted(crashed)} crashed",
                    })
                    if backoff > 0:
                        self._log(f"supervisor: backing off {backoff:.1f}s before "
                                  f"relaunching host(s) {sorted(crashed)}")
                        self._sleep(backoff)
                    do_resume = os.path.exists(self._model_file)
                    for p, (rec, rc) in crashed.items():
                        new = self._pod_launch(p, attempt, do_resume, generation, monitor)
                        new.update(crash_t=crash_t, prev_rc=rc, backoff=backoff)
                        children[p] = new
                        relaunched.append(new)
                    continue
                if self._straggler_timeout_s > 0:
                    for p, rec in list(children.items()):
                        _, age = read_heartbeat(self._runtime_dir, p)
                        # Only a heartbeat this incarnation wrote (its mtime
                        # after the launch) can go stale: bring-up writes
                        # nothing and must never read as a straggler, nor may
                        # a previous run's old file.
                        if (age is not None and age > self._straggler_timeout_s
                                and time.time() - age > rec["launched_wall"]):
                            monitor.emit("fault", step=rec["last_step"][0],
                                         event="straggler_kill", process=p, age_s=round(age, 3))
                            self._log(
                                f"supervisor: host {p} heartbeat stale {age:.1f}s > "
                                f"{self._straggler_timeout_s:.1f}s — SIGKILLing the straggler"
                            )
                            try:
                                rec["proc"].kill()
                            except OSError:
                                pass
            else:
                self._log(f"supervisor: pod completed cleanly after {attempt} "
                          "restart incident(s)")
                return 0
            # Out of the loop by a break: tear the remaining children down.
            for rec in children.values():
                if rec["proc"].poll() is None:
                    rec["proc"].kill()
            for rec in children.values():
                rec["proc"].wait()
                rec["tail"].join(timeout=5.0)
            return final_rc or 1
        finally:
            # Restart records not sent at first progress (a child that ended
            # at once, or died again first): emit_restart is idempotent.
            for rec in relaunched:
                rec["emit_restart"]()
            summary: dict = {"supervisor_restarts": self.restarts}
            if self.mttr_s:
                summary["mttr_s_median"] = round(statistics.median(self.mttr_s), 3)
                summary["mttr_s_max"] = round(max(self.mttr_s), 3)
            monitor.close(**summary)
