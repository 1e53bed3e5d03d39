"""Multi-process coordination for ``dist_train`` / ``dist_predict`` — the
counterpart of ``fast_tffm_tpu/distributed.py``.

  * **bring-up** — ``initialize_runtime`` joins the process into the
    default ``torch.distributed`` group (``parallel/multihost.py``: the
    ``[Distributed]`` keys, a launcher's environment, or a group the caller
    already initialized) and returns a ``DistributedRuntime``.  Under the
    pod supervisor (``FM_DIST_GENERATION`` set by ``resilience.Supervisor``
    with ``processes`` > 1) it parks until the supervisor's generation file
    names this process's generation, starts the ``GenerationWatcher``, then
    joins the group at the generation's ``coordinator`` (rank 0's TCP
    store) and starts this host's ``HeartbeatWriter``.
  * **DistributedRuntime** — barriers and a small cross-process KV store:
    the process group's own store (``StoreKV``) when a group is up, a
    shared-filesystem ``FileKV`` under ``runtime_dir`` as the fallback,
    no-ops single-process.  The checkpoint writer uses it for the
    single-writer publish protocol (rank 0 writes, every other rank waits
    on the published content signature and posts its input cursor), resume
    to check that every rank restored the same step, chain head and cursor,
    and ``on_nan = rollback`` for its barrier.
  * **heartbeats + HostMonitor** — every host writes ``hb-<p>.json`` under
    the shared runtime dir; a monitor thread classifies a stale peer as a
    host-level ``kind=stall`` (``host-heartbeat-lost``) long before a
    collective's own timeout.
  * **the generation protocol** — a process group cannot take a
    relaunched rank back, and a dead rank 0 takes the store with it, so
    recovery is generational: the pod supervisor owns ``generation.json``
    ({generation, coordinator, num_processes, cause}).  When one host dies
    the supervisor relaunches only that host and bumps the generation with
    a fresh coordinator port; every survivor's ``GenerationWatcher`` thread
    sees the bump and re-execs the process in place (``os.execv``: the same
    PID, a fresh image, ``--resume`` forced), from a side thread because
    the main thread is typically blocked in a collective whose peer is
    gone.  The new generation meets at the new store, restores the same
    chain head and resumes at the saved cursor vector.

The file formats are the JAX package's: either package reads the other's
``generation.json`` and heartbeats.  There is no counterpart of the JAX
``enable_cpu_collectives``: gloo is already the CPU backend.

Like the JAX module, this one imports without torch (the pod supervisor
imports it); torch is imported where a process group is used.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

from fast_tffm_tpu_torch.telemetry import log_quietly

__all__ = [
    "PEER_LOST_EXIT",
    "PeerLostError",
    "DistributedRuntime",
    "FileKV",
    "StoreKV",
    "initialize_runtime",
    "host_metrics_path",
    "free_port",
    "read_generation",
    "write_generation",
    "wait_for_generation",
    "GENERATION_FILE",
    "HeartbeatWriter",
    "HostMonitor",
    "GenerationWatcher",
    "read_heartbeat",
    "reexec_argv",
    "process_identity",
]

# Exit code of a trainer that dies because a PEER was lost (the JAX value).
PEER_LOST_EXIT = 17

GENERATION_FILE = "generation.json"

# The pod supervisor's environment contract (the JAX names).
ENV_RUNTIME_DIR = "FM_DIST_RUNTIME_DIR"
ENV_PROCESS_ID = "FM_DIST_PROCESS_ID"
ENV_PROCESSES = "FM_DIST_PROCESSES"
ENV_GENERATION = "FM_DIST_GENERATION"

class PeerLostError(RuntimeError):
    """A cross-process barrier or KV wait timed out: a peer is gone (or
    wedged past the deadline).  Under the pod supervisor the caller exits
    with ``PEER_LOST_EXIT``: the generation bump is on its way."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_identity() -> tuple[int, int]:
    """(rank, world size) without starting anything: the default process
    group's when one is up, the pod supervisor's environment contract
    otherwise, (0, 1) for a plain process."""
    if "torch.distributed" in sys.modules:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    try:
        return int(os.environ.get(ENV_PROCESS_ID, "0")), int(os.environ.get(ENV_PROCESSES, "1"))
    except ValueError:
        return 0, 1


def host_metrics_path(path: str, process_index: int | None = None) -> str:
    """Per-rank telemetry path: rank 0 keeps ``path``, rank p > 0 writes
    ``path`` with ``.p<N>`` before the extension (``run.jsonl`` ->
    ``run.p1.jsonl``); tools/report.py merges them."""
    if not path:
        return path
    p = process_identity()[0] if process_index is None else int(process_index)
    if p == 0:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.p{p}{ext or ''}"


# ---------------------------------------------------------------------------
# the generation file (supervisor <-> children)
# ---------------------------------------------------------------------------


def write_generation(runtime_dir: str, info: dict) -> str:
    """Publish a generation record ({generation, coordinator, num_processes,
    cause}) atomically: the supervisor's one source of truth for which pod
    incarnation is current."""
    os.makedirs(runtime_dir, exist_ok=True)
    path = os.path.join(runtime_dir, GENERATION_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_generation(runtime_dir: str) -> dict | None:
    try:
        with open(os.path.join(runtime_dir, GENERATION_FILE)) as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def wait_for_generation(runtime_dir: str, at_least: int, timeout_s: float = 120.0,
                        poll_s: float = 0.1) -> dict:
    """Block until the generation file names a generation >= ``at_least``
    (a relaunched or re-exec'd child parking until the supervisor has
    published the incarnation it belongs to)."""
    deadline = time.monotonic() + timeout_s
    while True:
        info = read_generation(runtime_dir)
        if info is not None and int(info.get("generation", -1)) >= at_least:
            return info
        if time.monotonic() > deadline:
            raise PeerLostError(
                f"no generation >= {at_least} appeared in {runtime_dir} "
                f"within {timeout_s:.0f}s (supervisor gone?)"
            )
        time.sleep(poll_s)


# ---------------------------------------------------------------------------
# KV backends
# ---------------------------------------------------------------------------


class FileKV:
    """Shared-filesystem KV and barrier: one file per key under ``root``
    (the fallback and unit-test backend).  A barrier is every process
    publishing a marker and polling for all P of them."""

    def __init__(self, root: str, poll_s: float = 0.05):
        self._root = root
        self._poll = poll_s
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self._root, key.replace("/", "_"))

    def set(self, key: str, value: str) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(value)
        os.replace(tmp, path)

    def get(self, key: str, timeout_s: float) -> str:
        path = self._path(key)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                with open(path) as f:
                    return f.read()
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"key {key!r} did not appear in {timeout_s:.0f}s")
            time.sleep(self._poll)

    def barrier(self, name: str, timeout_s: float, process_count: int,
                process_index: int) -> None:
        self.set(f"{name}.{process_index}", "1")
        for p in range(process_count):
            self.get(f"{name}.{p}", timeout_s)


class StoreKV:
    """The KV and barrier on a ``torch.distributed`` store (the default
    group's TCP or file store): the counterpart of the JAX package's
    coordination-service KV."""

    def __init__(self, store):
        self._store = store

    def set(self, key: str, value: str) -> None:
        self._store.set(key, value)

    def get(self, key: str, timeout_s: float) -> str:
        import datetime

        try:
            self._store.wait([key], datetime.timedelta(seconds=timeout_s))
            return self._store.get(key).decode()
        except RuntimeError as e:  # the store's timeout
            raise TimeoutError(str(e)) from e

    def barrier(self, name: str, timeout_s: float, process_count: int,
                process_index: int) -> None:
        self.set(f"{name}.{process_index}", "1")
        for p in range(process_count):
            self.get(f"{name}.{p}", timeout_s)


def _default_store():
    import torch.distributed as dist

    try:
        return dist.distributed_c10d._get_default_store()
    # analysis: ok exception-hygiene capability probe: a build without the store accessor falls back to the FileKV
    except Exception:
        return None


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


_RUNTIME_ORDINAL = [0]  # process-global DistributedRuntime construction count


class DistributedRuntime:
    """Cross-process coordination for one run (the JAX class).

    Inactive (every method a cheap no-op) when single-process or no KV
    backend is reachable.  Every method is called in the same order on
    every process; keys self-namespace with per-tag counters, an instance
    ordinal and an epoch namespace (``advance_namespace``, bumped between
    rollback attempts).  A timed-out wait raises ``PeerLostError``."""

    runtime_dir: str | None = None
    heartbeat = None
    watcher = None

    def __init__(self, process_index: int = 0, process_count: int = 1, kv=None, *,
                 barrier_timeout_s: float = 120.0, log=print, instance: int | None = None):
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self._kv = kv
        self.barrier_timeout_s = float(barrier_timeout_s)
        self._log = log
        self._ns = 0
        self._counters: dict[str, int] = {}
        if instance is None:
            _RUNTIME_ORDINAL[0] += 1
            instance = _RUNTIME_ORDINAL[0]
        self._instance = int(instance)

    @classmethod
    def create(cls, *, barrier_timeout_s: float = 120.0, runtime_dir: str | None = None,
               log=print) -> "DistributedRuntime":
        """The process group's store when a group is up, ``FileKV`` under
        ``runtime_dir`` otherwise, inert for single-process runs."""
        p, n = process_identity()
        if n <= 1:
            return cls(0, 1, None, barrier_timeout_s=barrier_timeout_s, log=log)
        store = _default_store()
        if store is not None:
            kv = StoreKV(store)
        elif runtime_dir:
            kv = FileKV(os.path.join(runtime_dir, "kv"))
        else:
            kv = None
            log("warning: multi-process run with no coordination backend — "
                "save-signature barriers disabled (set [Distributed] "
                "runtime_dir for the shared-filesystem fallback)")
        return cls(p, n, kv, barrier_timeout_s=barrier_timeout_s, log=log)

    @property
    def active(self) -> bool:
        return self.process_count > 1 and self._kv is not None

    @property
    def is_lead(self) -> bool:
        return self.process_index == 0

    def advance_namespace(self) -> None:
        self._ns += 1
        self._counters.clear()

    def _next(self, tag: str) -> int:
        n = self._counters.get(tag, 0)
        self._counters[tag] = n + 1
        return n

    def _key(self, *parts) -> str:
        return "/".join((f"fmr{self._instance}", str(self._ns), *map(str, parts)))

    def _get(self, key: str, what: str):
        try:
            return json.loads(self._kv.get(key, self.barrier_timeout_s))
        except TimeoutError as e:
            raise PeerLostError(f"{what}: {e}") from e

    def barrier(self, tag: str) -> None:
        """Returns once every process has called the same barrier."""
        if not self.active:
            return
        name = self._key("b", tag, self._next(f"b:{tag}"))
        try:
            self._kv.barrier(name, self.barrier_timeout_s, self.process_count,
                             self.process_index)
        except TimeoutError as e:
            raise PeerLostError(f"barrier {tag!r}: {e}") from e

    def publish_signature(self, seq: int, sig: str | None, meta: str = "") -> None:
        """The writer's side of a publish: save boundary ``seq``'s content
        signature ``sig`` is durable (``sig`` None with ``meta = "failed"``:
        the write failed)."""
        if not self.active:
            return
        self._kv.set(self._key("sig", seq), json.dumps({"sig": sig, "meta": meta}))

    def await_signature(self, seq: int) -> dict | None:
        """A non-writer's side: block until the lead published boundary
        ``seq`` (the save barrier)."""
        if not self.active:
            return None
        return self._get(self._key("sig", seq), f"awaiting save signature {seq}")

    def share_cursor(self, seq: int, cursor: dict | None) -> list | None:
        """Every process posts its input cursor for boundary ``seq``; the
        lead returns the per-process vector, the others None."""
        if not self.active:
            return None
        self._kv.set(self._key("cur", seq, self.process_index), json.dumps(cursor))
        if not self.is_lead:
            return None
        return [self._get(self._key("cur", seq, p), f"gathering cursor {seq} from host {p}")
                for p in range(self.process_count)]

    def broadcast(self, tag: str, value):
        """The lead's ``value`` on every process (run identity)."""
        if not self.active:
            return value
        key = self._key("bc", tag, self._next(f"bc:{tag}"))
        if self.is_lead:
            self._kv.set(key, json.dumps(value))
        return self._get(key, f"broadcast {tag!r}")

    def allgather(self, tag: str, value) -> list:
        """Every process posts ``value`` and returns the per-process list."""
        if not self.active:
            return [value]
        n = self._next(f"ag:{tag}")
        self._kv.set(self._key("ag", tag, n, self.process_index), json.dumps(value))
        return [self._get(self._key("ag", tag, n, p), f"allgather {tag!r}: waiting on host {p}")
                for p in range(self.process_count)]

    def agree(self, tag: str, value) -> list:
        """Every process posts ``value``; raises, naming the hosts, unless
        all P values are identical (the restore-consistency check)."""
        if not self.active:
            return [value]
        n = self._next(f"a:{tag}")
        self._kv.set(self._key("agree", tag, n, self.process_index), json.dumps(value))
        vals = [self._get(self._key("agree", tag, n, p), f"agree {tag!r}: waiting on host {p}")
                for p in range(self.process_count)]
        if any(v != vals[0] for v in vals[1:]):
            detail = ", ".join(f"host {p}: {v!r}" for p, v in enumerate(vals))
            raise RuntimeError(
                f"hosts disagree on {tag} — {detail}.  Refusing to train on "
                "desynced state (is every host reading the same checkpoint "
                "chain / dataset?)"
            )
        return vals


# ---------------------------------------------------------------------------
# heartbeats and the host monitor
# ---------------------------------------------------------------------------


def _hb_path(runtime_dir: str, process_index: int) -> str:
    return os.path.join(runtime_dir, f"hb-{process_index}.json")


class HeartbeatWriter:
    """A daemon thread that publishes this host's liveness and training
    position (``{process, step, wall}``) every ``interval_s`` under the
    shared runtime dir.  Freshness is the file's mtime (hosts' wall clocks
    need not agree); the step feeds straggler detection.  ``close`` stops
    the thread and writes the last position once more."""

    def __init__(self, runtime_dir: str, process_index: int, interval_s: float = 2.0):
        self._path = _hb_path(runtime_dir, process_index)
        self._process = int(process_index)
        self._interval = float(interval_s)
        self._step = 0
        self._stop = threading.Event()
        os.makedirs(runtime_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._run, name="dist-heartbeat", daemon=True)
        self._thread.start()

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def _write(self) -> None:
        tmp = f"{self._path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"process": self._process, "step": self._step, "wall": time.time()}, f)
            os.replace(tmp, self._path)
        except OSError:
            pass  # a full or unwritable runtime dir must not kill training

    def _run(self) -> None:
        self._write()
        while not self._stop.wait(self._interval):
            self._write()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._write()


def read_heartbeat(runtime_dir: str, process_index: int) -> tuple[dict | None, float | None]:
    """(payload, seconds since the last write) of one host's heartbeat file;
    (None, None) when it does not exist or cannot be read."""
    path = _hb_path(runtime_dir, process_index)
    try:
        age = time.time() - os.path.getmtime(path)
        with open(path) as f:
            payload = json.load(f)
        return (payload if isinstance(payload, dict) else None), age
    except (OSError, ValueError):
        return None, None


class HostMonitor:
    """A daemon thread watching the PEERS' heartbeats: a peer whose file goes
    stale past ``timeout_s`` calls ``on_event(peer, classification,
    detail)`` once per episode (re-armed when the peer freshens).  The
    classification is ``host-heartbeat-lost`` (no write: dead, or wedged
    before entering a collective).  A slow peer that still writes is not
    classified here: every step's collective holds the ranks in lock-step,
    so it is never steps behind; the supervisor kills a peer whose
    heartbeat ages past ``straggler_timeout_s``.  The trainers' events
    become kind=stall records."""

    def __init__(self, runtime_dir: str, process_index: int, process_count: int,
                 timeout_s: float, on_event, *, poll_s: float = 1.0):
        self._dir = runtime_dir
        self._process = int(process_index)
        self._count = int(process_count)
        self._timeout = float(timeout_s)
        self._on_event = on_event
        self._poll = float(poll_s)
        self._fired: dict[tuple[int, str], bool] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="dist-hostmonitor", daemon=True)
        self._thread.start()

    def _emit_once(self, peer: int, classification: str, detail: dict) -> None:
        key = (peer, classification)
        if self._fired.get(key):
            return
        self._fired[key] = True
        try:
            self._on_event(peer, classification, detail)
        # analysis: ok exception-hygiene the owner's event callback; the monitor thread outlives any bug in it (the episode already fired)
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            for p in range(self._count):
                if p == self._process:
                    continue
                payload, age = read_heartbeat(self._dir, p)
                if age is None:
                    continue  # never seen: the peer is still in bring-up
                if age > self._timeout:
                    self._emit_once(p, "host-heartbeat-lost",
                                    {"age_s": round(age, 3),
                                     "last_step": (payload or {}).get("step")})
                    continue
                self._fired.pop((p, "host-heartbeat-lost"), None)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# the generation watcher (a survivor's recovery)
# ---------------------------------------------------------------------------


def reexec_argv(argv: list[str]) -> list[str]:
    """The argv a survivor re-execs with: ``--resume`` forced (the point is
    restoring the shared chain head) and any armed fault plan stripped
    (a plan fires on the first incarnation only: a kill armed again on
    every re-exec would crash-loop the pod)."""
    out: list[str] = []
    skip = 0
    for a in argv:
        if skip:
            skip -= 1
            continue
        if a in ("--fault-plan", "--fault-seed", "--fault-horizon", "--fault-process"):
            skip = 1
            continue
        if a.startswith("--fault-"):
            continue
        if a == "--resume":
            continue  # added once below
        out.append(a)
    out.append("--resume")
    return out


class GenerationWatcher:
    """A daemon thread: when the supervisor bumps ``generation.json`` past
    this process's generation, re-exec in place (the same PID, a fresh
    image, ``reexec_argv``) so this host joins the new pod generation.  The
    exec runs from the side thread on purpose: the main thread is typically
    blocked in a collective whose peer just died, where no Python-level
    signal or exception reaches it.

    ``argv`` defaults to the interpreter's own command line after the
    executable (``sys.orig_argv[1:]``, so ``-m fast_tffm_tpu_torch.cli ...``
    re-execs as it was launched); ``exec_fn(generation, argv)`` replaces the
    exec (tests)."""

    def __init__(self, runtime_dir: str, generation: int, *, argv: list[str] | None = None,
                 poll_s: float = 0.25, log=print, exec_fn=None):
        self._dir = runtime_dir
        self._generation = int(generation)
        self._argv = list(argv if argv is not None else sys.orig_argv[1:])
        self._poll = float(poll_s)
        self._log = log
        self._exec = exec_fn if exec_fn is not None else self._do_exec
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="dist-genwatcher", daemon=True)
        self._thread.start()

    def _do_exec(self, new_generation: int, argv: list[str]) -> None:
        os.environ[ENV_GENERATION] = str(new_generation)
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable, *argv])

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            info = read_generation(self._dir)
            if info is None:
                continue
            gen = int(info.get("generation", -1))
            if gen > self._generation:
                log_quietly(
                    self._log,
                    f"distributed: generation {self._generation} -> {gen} "
                    f"(cause: {info.get('cause', '?')}) — re-exec'ing into "
                    "the new pod generation with --resume",
                )
                self._exec(gen, reexec_argv(self._argv))
                return  # reached only with an injected exec_fn

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------


def initialize_runtime(cfg, log=print, device="cuda") -> DistributedRuntime:
    """Bring-up for ``dist_train`` / ``dist_predict``; returns the run's
    ``DistributedRuntime`` (inert single-process).  Two ways in:

      * **a supervised pod** (``FM_DIST_GENERATION`` set by
        ``resilience.Supervisor``): park until the generation file names
        this process's generation (the restore barrier of a relaunched or
        re-exec'd host), start the ``GenerationWatcher`` BEFORE the
        blocking group init, join the default group at the generation's
        ``coordinator`` (rank 0's TCP store) with world
        ``num_processes`` and rank ``FM_DIST_PROCESS_ID``, then start this
        host's ``HeartbeatWriter``;
      * **classic** (``parallel.multihost.maybe_initialize_distributed``:
        an initialized group as it is, the ``[Distributed]`` keys, a
        launcher's environment), with a heartbeat when more than one
        process runs and a ``runtime_dir`` is set."""
    from fast_tffm_tpu_torch.parallel.multihost import maybe_initialize_distributed

    runtime_dir = os.environ.get(ENV_RUNTIME_DIR, "") or cfg.runtime_dir
    gen_env = os.environ.get(ENV_GENERATION)
    watcher = heartbeat = None
    if gen_env is not None and runtime_dir:
        pid = int(os.environ.get(ENV_PROCESS_ID, "0"))
        info = wait_for_generation(runtime_dir, int(gen_env),
                                   timeout_s=float(cfg.barrier_timeout_s))
        my_gen = int(info["generation"])
        os.environ[ENV_GENERATION] = str(my_gen)
        # Up before the blocking init: a peer that dies during bring-up
        # itself must still be recoverable.
        watcher = GenerationWatcher(runtime_dir, my_gen, log=log)
        nproc = int(info["num_processes"])
        log(f"distributed: joining pod generation {my_gen} as process "
            f"{pid}/{nproc} (coordinator {info['coordinator']})")
        maybe_initialize_distributed(info["coordinator"], nproc, pid, device=device,
                                     timeout_s=cfg.barrier_timeout_s)
        heartbeat = HeartbeatWriter(runtime_dir, pid, interval_s=cfg.heartbeat_s)
    else:
        maybe_initialize_distributed(cfg.coordinator_address, cfg.num_processes,
                                     cfg.process_id, device=device,
                                     timeout_s=cfg.barrier_timeout_s)
        p, n = process_identity()
        if n > 1 and runtime_dir:
            heartbeat = HeartbeatWriter(runtime_dir, p, interval_s=cfg.heartbeat_s)
    runtime = DistributedRuntime.create(barrier_timeout_s=cfg.barrier_timeout_s,
                                        runtime_dir=runtime_dir or None, log=log)
    runtime.runtime_dir = runtime_dir or None
    runtime.heartbeat = heartbeat
    runtime.watcher = watcher
    if runtime.process_count > 1:
        log_quietly(log, f"distributed: rank {runtime.process_index} of "
                         f"{runtime.process_count}")
    return runtime
