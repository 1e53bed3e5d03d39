"""Multi-process coordination for ``dist_train`` / ``dist_predict`` — the
counterpart of the bring-up and coordination half of
``fast_tffm_tpu/distributed.py``.

  * **bring-up** — ``initialize_runtime`` joins the process into the
    default ``torch.distributed`` group (``parallel/multihost.py``: the
    ``[Distributed]`` keys, a launcher's environment, or a group the caller
    already initialized) and returns a ``DistributedRuntime``.
  * **DistributedRuntime** — barriers and a small cross-process KV store:
    the process group's own store (``StoreKV``) when a group is up, a
    shared-filesystem ``FileKV`` under ``runtime_dir`` as the fallback,
    no-ops single-process.  The checkpoint writer uses it for the
    single-writer publish protocol (rank 0 writes, every other rank waits
    on the published content signature and posts its input cursor), resume
    to check that every rank restored the same step, chain head and cursor,
    and ``on_nan = rollback`` for its barrier.

Pod supervision (heartbeats, the host monitor, the generation file and its
watcher, re-exec into the next pod incarnation) is the next slice of the
port (ROADMAP.md §A item 10); ``initialize_runtime`` refuses the settings
that need it.

Like the JAX module, this one imports without torch; torch is imported
where a process group is used.
"""

from __future__ import annotations

import json
import os
import socket
import sys
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
    "process_identity",
]

# Exit code of a trainer that dies because a PEER was lost (the JAX value).
PEER_LOST_EXIT = 17

# The pod supervisor's environment contract (the JAX names).
ENV_RUNTIME_DIR = "FM_DIST_RUNTIME_DIR"
ENV_PROCESS_ID = "FM_DIST_PROCESS_ID"
ENV_PROCESSES = "FM_DIST_PROCESSES"
ENV_GENERATION = "FM_DIST_GENERATION"

POD_SUPERVISION = (
    "pod supervision (heartbeats, the host monitor, the generation file and "
    "re-exec, the pod Supervisor) is item 10 of ROADMAP.md §A, which "
    "fast_tffm_tpu_torch has not ported yet; use fast_tffm_tpu"
)


class PeerLostError(RuntimeError):
    """A cross-process barrier or KV wait timed out: a peer is gone (or
    wedged past the deadline)."""


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


def initialize_runtime(cfg, log=print, device="cuda") -> DistributedRuntime:
    """Bring-up for ``dist_train`` / ``dist_predict``: join the default
    process group (``parallel.multihost.maybe_initialize_distributed``:
    an initialized group as it is, the ``[Distributed]`` keys, a
    launcher's environment) and return the run's ``DistributedRuntime``
    (inert single-process).  A pod supervisor's child and ``[Distributed]
    host_stall_timeout_s`` > 0 are refused: pod supervision is a later
    slice."""
    if os.environ.get(ENV_GENERATION) is not None:
        raise ValueError(f"this process was launched by a pod supervisor: {POD_SUPERVISION}")
    if float(cfg.host_stall_timeout_s) > 0:
        raise ValueError(
            f"[Distributed] host_stall_timeout_s = {cfg.host_stall_timeout_s} arms the "
            f"peer-heartbeat monitor: {POD_SUPERVISION}"
        )
    from fast_tffm_tpu_torch.parallel.multihost import maybe_initialize_distributed

    maybe_initialize_distributed(cfg.coordinator_address, cfg.num_processes, cfg.process_id,
                                 device=device, timeout_s=cfg.barrier_timeout_s)
    runtime_dir = os.environ.get(ENV_RUNTIME_DIR, "") or cfg.runtime_dir
    runtime = DistributedRuntime.create(barrier_timeout_s=cfg.barrier_timeout_s,
                                        runtime_dir=runtime_dir or None, log=log)
    runtime.runtime_dir = runtime_dir or None
    if runtime.process_count > 1:
        log_quietly(log, f"distributed: rank {runtime.process_index} of "
                         f"{runtime.process_count}")
    return runtime
