"""Run telemetry: one envelope, three sentinels, one sink — the counterpart
of ``fast_tffm_tpu/telemetry.py``.

``RunMonitor`` stamps every record with the JAX package's envelope
(``run_id``, ``schema_version``, ``kind``, ``step``, ``t``, ``ts``,
``process_index``, ``process_count``) and checks its kind against
``SCHEMAS``, which are the JAX package's, key for key
(``tools/analysis/formats.lock.json`` pins them), so ``tools/report.py``
reads a port run as it reads a JAX run.

  * **compile sentinel** — the port's "compiles" are a kernel library built
    by ``ops/kernel_build.py`` (``nvcc`` for a ``.cu``, ``g++`` for the
    parser) and a CUDA-graph capture by ``utils/step_graph.py``; each bumps
    a process-wide counter (``note_compile``), and a library loaded from the
    ``_build/`` cache without a build counts as a cache hit
    (``note_cache_hit``).  ``on_dispatch`` drains the delta per call of a loop,
    so a build or capture after the warm-up surfaces as a steady-state
    ``kind=compile`` record.
  * **memory watermarks** — ``kind=mem`` records with the host RSS (/proc,
    ru_maxrss as the peak floor) and the run device's allocated bytes
    (``torch.cuda.memory_allocated``; the peak from ``max_memory_allocated``;
    None on the CPU), sampled by the monitor's own thread — never a device
    sync, never on the loop's path — and once more at close.
  * **liveness watchdog** — when no call completes for ``stall_timeout_s``
    it records every Python thread's stack and the prefetch queue depth as
    a ``kind=stall`` record, classified input-starved (empty queue) or
    device-bound (a thread waits on the card); suspended through phases
    that complete no call (``suspended()``: validation, saves), deferred
    while a stack shows a build or a capture (slow, not stuck; up to 10x
    the deadline, then classified "compiling").  One record per episode.

Importing this module initialises no CUDA context and imports no torch:
``device_live_bytes`` reads torch only when the caller has imported it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
import traceback

from fast_tffm_tpu_torch.utils.tracing import MetricsLogger

__all__ = [
    "SCHEMA_VERSION",
    "ENVELOPE_FIELDS",
    "SCHEMAS",
    "RunMonitor",
    "CompileSentinel",
    "note_compile",
    "note_cache_hit",
    "new_run_id",
    "artifact_stamp",
    "write_json_artifact",
    "log_quietly",
    "thread_stacks",
    "classify_stall",
    "compiling_now",
    "device_live_bytes",
    "arm_hang_exit",
    "enable_compilation_cache",
]

SCHEMA_VERSION = 1

# The JAX package's envelope and per-kind required keys, unchanged: a
# record of the port and a record of the JAX package are read alike.
ENVELOPE_FIELDS = (
    "run_id",
    "schema_version",
    "kind",
    "step",
    "t",
    "ts",
    "process_index",
    "process_count",
)

SCHEMAS: dict[str, tuple[str, ...]] = {
    "train": ("epoch", "loss", "examples_per_sec", "examples_per_sec_per_chip"),
    "validation": ("epoch", "validation_auc"),
    "input": ("input_items", "input_steps", "input_examples", "parse_ms"),
    "predict": ("examples", "examples_per_sec"),
    "serving": ("requests", "flushes", "rows", "queue_ms", "compute_ms", "total_ms"),
    "compile": ("source", "compiles", "total_compiles", "warmup"),
    "mem": (
        "host_rss_bytes",
        "host_rss_peak_bytes",
        "device_bytes",
        "device_peak_bytes",
    ),
    "stall": (
        "deadline_s",
        "since_last_step_s",
        "classification",
        "prefetch_queue_depth",
        "stacks",
    ),
    "anomaly": ("event", "loss"),
    "fault": ("event",),
    "restart": ("attempt", "exit_code", "backoff_s", "mttr_s"),
    "ckpt": (
        "mode",  # full (async) | delta | sync
        "snapshot_ms",
        "convert_ms",
        "d2h_ms",
        "write_ms",
        "bytes",
        "rows_written",
        "train_stall_ms",
    ),
    "profile": ("program", "flops", "bytes_accessed"),
    "datastats": (
        "window_steps",
        "ids",
        "unique",
        "dedup_ratio",
        "rows_seen",
        "hh_k",
        "hh_topk_mass",
    ),
    "freshness": (
        "publish_step",
        "publish_to_applied_ms",
        "publish_to_first_scored_ms",
    ),
    "quality": ("hour", "auc_online", "auc_batch"),
    "soak": ("phase", "elapsed_s", "ok"),
    "tiering": (
        "hit_rate",
        "miss_rows",
        "miss_bytes_per_step",
        "writeback_rows",
        "writeback_ms",
        "resolve_ms",
        "restages",
        "pending_rows",
    ),
    "summary": ("total_compiles", "steady_compiles", "stalls", "anomalies"),
}


def new_run_id() -> str:
    """Sortable by start time and collision-safe across processes."""
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid():x}-{os.urandom(3).hex()}"


def artifact_stamp(run_id: str = "") -> dict:
    """The join keys of a JSON artifact measured from a monitored run: its
    ``run_id`` (a fresh one when the tool started no run) and the envelope's
    ``schema_version``."""
    return {"run_id": run_id or new_run_id(), "schema_version": SCHEMA_VERSION}


def device_stamp(device) -> dict:
    """What a measuring driver's artifact names its numbers by: the device
    it ran on, the card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (None on the CPU),
    and the torch and CUDA versions."""
    import subprocess

    import torch

    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={index}"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    return {
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "card": card,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def write_json_artifact(path, obj, *, indent: int = 1, sort_keys: bool = True) -> None:
    """Publish a JSON artifact atomically: a sibling tmp file, then
    ``os.replace``, so a reader never sees a torn file."""
    tmp = f"{path}.{os.getpid():x}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=indent, sort_keys=sort_keys)
        f.write("\n")
    os.replace(tmp, path)


def log_quietly(log, msg: str) -> None:
    """Deliver ``msg`` to a caller's log callback, absorbing any failure it
    raises: threads that must keep running (writers, the watchdog) log
    through here, and the diagnosis always travels a typed path too."""
    if log is None:
        return
    try:
        log(msg)
    # analysis: ok exception-hygiene the sanctioned raising-log-callback sink — the diagnosis already traveled a typed path; see docstring
    except Exception:
        pass


# -- compile sentinel -----------------------------------------------------

_compile_lock = threading.Lock()
_compile_count = 0
_cache_hit_count = 0


def note_compile(n: int = 1) -> None:
    """Count ``n`` compiles: a kernel library built, a CUDA graph captured."""
    global _compile_count
    with _compile_lock:
        _compile_count += n


def note_cache_hit(n: int = 1) -> None:
    """Count a kernel library loaded from the build cache without a build."""
    global _cache_hit_count
    with _compile_lock:
        _cache_hit_count += n


def global_compile_count() -> int:
    with _compile_lock:
        return _compile_count


def global_cache_hit_count() -> int:
    with _compile_lock:
        return _cache_hit_count


def enable_compilation_cache(path: str, log=None) -> bool:
    """``[Telemetry] compilation_cache_dir``: the JAX package points XLA's
    persistent cache there.  The port's kernels are cached in its
    ``_build/`` directory already and a CUDA graph cannot be persisted, so
    this logs a note and returns False (no cache was engaged)."""
    log_quietly(
        log,
        f"note: compilation_cache_dir = {path} names the JAX package's XLA cache; "
        "the port's kernel libraries are cached in fast_tffm_tpu_torch/_build/ and "
        "CUDA graphs are captured per process",
    )
    return False


class CompileSentinel:
    """Per-consumer view of the process-wide compile counter: ``drain()``
    gives the compiles since the previous drain (or construction)."""

    def __init__(self):
        self._seen = global_compile_count()
        self._seen_hits = global_cache_hit_count()

    def drain(self) -> int:
        n = global_compile_count()
        delta, self._seen = n - self._seen, n
        return delta

    def drain_cache_hits(self) -> int:
        n = global_cache_hit_count()
        delta, self._seen_hits = n - self._seen_hits, n
        return delta


# -- memory watermarks ----------------------------------------------------


def host_rss_bytes() -> int | None:
    """Current resident set size (linux /proc; None where unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def _ru_maxrss_bytes() -> int | None:
    try:
        import resource

        v = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(v) if sys.platform == "darwin" else int(v) * 1024
    except (ImportError, OSError, ValueError):
        return None


def device_live_bytes(device=None) -> tuple[int, int] | None:
    """(allocated, peak allocated) bytes of the caching allocator on
    ``device``, a CUDA ``torch.device``; None for the CPU, no device, or
    before the caller has imported torch and set the card up.  Reads the
    allocator's counters on the host: no device sync."""
    torch = sys.modules.get("torch")
    if torch is None or device is None or getattr(device, "type", None) != "cuda":
        return None
    if not torch.cuda.is_initialized():
        return None
    return (int(torch.cuda.memory_allocated(device)),
            int(torch.cuda.max_memory_allocated(device)))


class _MemWatermarks:
    """Sample and track peaks; ru_maxrss floors the host peak."""

    def __init__(self, device=None):
        self._device = device
        self._host_peak = 0
        self._dev_peak = 0

    def sample(self) -> dict:
        host = host_rss_bytes()
        dev = device_live_bytes(self._device)
        if host is not None:
            self._host_peak = max(self._host_peak, host)
        maxrss = _ru_maxrss_bytes()
        if maxrss is not None:
            self._host_peak = max(self._host_peak, maxrss)
        if dev is not None:
            self._dev_peak = max(self._dev_peak, *dev)
        return {
            "host_rss_bytes": host,
            "host_rss_peak_bytes": self._host_peak or None,
            "device_bytes": None if dev is None else dev[0],
            "device_peak_bytes": self._dev_peak if dev is not None else None,
        }


# -- stall forensics ------------------------------------------------------


def thread_stacks(max_frames: int = 25) -> dict[str, str]:
    """Formatted stack of every live Python thread (deepest frames kept),
    keyed by thread name."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident) or f"thread-{ident}"
        out[name] = "".join(traceback.format_stack(frame)[-max_frames:])
    return out


# Frames (function names and source lines) of a thread waiting on the card:
# a synchronize, a graph replay, a device-to-host copy.
_DEVICE_MARKERS = (
    "synchronize",
    ".replay(",
    ".item()",
    ".cpu()",
    ".numpy()",
    "torch/cuda",
)

# Frames of a build or a capture: slow, not stuck.
_COMPILING_MARKERS = (
    "kernel_build",
    "nvcc",
    "in _capture",
    "_build_host",
)


def compiling_now(stacks: dict[str, str]) -> bool:
    blob = "\n".join(stacks.values())
    return any(m in blob for m in _COMPILING_MARKERS)


def classify_stall(
    queue_depth: int | None, stacks: dict[str, str], producer_alive=None,
    stream_idle=None,
) -> str:
    """input-starved: the prefetch queue is empty, so the producer (parse,
    disk) is what the loop waits on — "(producer-thread dead)" when its
    thread is known dead, "(stream-idle)" when a followed stream is quiet.
    device-bound: data is ready (or there is no queue) and a thread waits
    on the card."""
    if queue_depth == 0:
        if producer_alive is False:
            return "input-starved (producer-thread dead)"
        if stream_idle:
            return "input-starved (stream-idle)"
        return "input-starved"
    blob = "\n".join(stacks.values())
    if any(m in blob for m in _DEVICE_MARKERS):
        return "device-bound"
    if queue_depth is not None and queue_depth > 0:
        return "device-bound"
    return "unknown"


def first_nonfinite_leaf(state) -> str | None:
    """Name of the first training-state tensor holding a NaN/Inf (``table``,
    ``table_accum``, ``dense[i]``, ``dense_accum[i]``), or None.  Syncs
    every tensor to the host: only on the way to an abort."""
    import torch

    named = [("table", state.table), ("table_accum", state.table_accum)]
    named += [(f"dense[{i}]", t) for i, t in enumerate(state.dense)]
    named += [(f"dense_accum[{i}]", t) for i, t in enumerate(state.dense_accum)]
    for name, t in named:
        if t is not None and t.is_floating_point() and t.numel() and not bool(
                torch.isfinite(t).all()):
            return name
    return None


# -- the monitor ----------------------------------------------------------


class RunMonitor:
    """Owns the MetricsLogger and stamps the shared envelope on every
    record; hosts the compile sentinel, the memory sampler and the liveness
    watchdog.  Thread-safe: the loops emit from their thread, the monitor's
    thread from its own.

    ``source`` names the entry point (train / predict / serving) on compile
    records.  ``device`` is the run's torch device (its allocator feeds
    kind=mem).  ``stall_timeout_s`` 0 disables the watchdog; ``mem_every_s``
    0 reduces kind=mem to the one close() record.  The monitor's thread
    runs when the watchdog is on or memory is sampled into a file."""

    def __init__(
        self,
        path: str | None = None,
        *,
        run_id: str = "",
        source: str = "train",
        stall_timeout_s: float = 0.0,
        mem_every_s: float = 0.0,
        queue_depth_fn=None,
        logger: MetricsLogger | None = None,
        replica: int | None = None,
        device=None,
        log=None,
    ):
        self._logger = logger if logger is not None else MetricsLogger(path)
        self._own_logger = logger is None
        self.run_id = run_id or new_run_id()
        self.source = source
        self.replica = replica
        # The emitting rank of a multi-process run (0 / 1 otherwise).
        from fast_tffm_tpu_torch.distributed import process_identity

        self.process_index, self.process_count = process_identity()
        self._log = log
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._step = 0
        self._closed = False

        self._sentinel = CompileSentinel()
        self.compiles_total = 0
        self.compiles_steady = 0  # compiles NOT marked warmup
        self._last_warmup = True  # nothing dispatched yet = warm-up
        self._warmup_depth = 0  # > 0: inside a warmup_window()

        self._mem = _MemWatermarks(device)
        self._mem_every_s = float(mem_every_s)
        self._last_mem = self._t0

        self.stalls = 0
        self.anomalies = 0
        self._stall_timeout = float(stall_timeout_s)
        self._queue_depth_fn = queue_depth_fn
        self._producer_alive_fn = None
        self._stream_idle_fn = None
        # Armed by the first heartbeat: the first call pays the builds and
        # captures, far beyond any stall deadline.
        self._last_beat = None
        self._stall_fired = False
        self._suspended = 0
        self._stop = threading.Event()
        self._watchdog = None
        if not self.active:
            self._mem_every_s = 0.0  # no file: nothing to sample for
        if self._stall_timeout > 0 or self._mem_every_s > 0:
            self._watchdog = threading.Thread(
                target=self._watch, name="telemetry-watchdog", daemon=True
            )
            self._watchdog.start()

    @property
    def active(self) -> bool:
        """Whether records reach a file (the sentinels run regardless)."""
        return self._logger.active

    def set_queue_depth_fn(self, fn) -> None:
        """Point the stall classifier at the current stream's queue depth."""
        self._queue_depth_fn = fn

    def set_producer_alive_fn(self, fn) -> None:
        """Point the stall classifier at the current producer's liveness."""
        self._producer_alive_fn = fn

    def set_stream_idle_fn(self, fn) -> None:
        """Point the stall classifier at the current stream's idle probe (a
        followed FMS stream polling a quiet file): a starved loop then
        classifies as input-starved (stream-idle), wait for the writer."""
        self._stream_idle_fn = fn

    # -- emission ---------------------------------------------------------

    def emit(self, kind: str, step: int | None = None, **fields) -> None:
        """Append one enveloped record.  An unknown ``kind`` raises."""
        if kind not in SCHEMAS:
            raise ValueError(f"unknown telemetry kind {kind!r} (register it in SCHEMAS)")
        envelope = dict(
            run_id=self.run_id,
            schema_version=SCHEMA_VERSION,
            kind=kind,
            step=self._step if step is None else int(step),
            t=round(time.monotonic() - self._t0, 3),
            process_index=self.process_index,
            process_count=self.process_count,
        )
        if self.replica is not None and "replica" not in fields:
            envelope["replica"] = self.replica
        self._logger.log(**envelope, **fields)

    def heartbeat(self, step: int) -> None:
        """The liveness signal: call whenever a call completes."""
        with self._lock:
            self._step = int(step)
            self._last_beat = time.monotonic()
            self._stall_fired = False

    @contextlib.contextmanager
    def suspended(self):
        """Suspend the watchdog for a phase that completes no call (a
        validation pass, a save).  Re-entrant; the heartbeat clock restarts
        on exit."""
        with self._lock:
            self._suspended += 1
        try:
            yield
        finally:
            with self._lock:
                self._suspended -= 1
                if self._last_beat is not None:
                    self._last_beat = time.monotonic()
                self._stall_fired = False

    @contextlib.contextmanager
    def warmup_window(self):
        """Compiles drained while a thread is inside count as warm-up (the
        first call's builds and captures); the trailing drain on exit
        catches the ones no call drained."""
        with self._lock:
            self._warmup_depth += 1
        try:
            yield
        finally:
            try:
                self.on_dispatch(self._step, warmup=True)
            except (OSError, ValueError):
                pass  # a failed drain is a lost record, not a broken window
            with self._lock:
                self._warmup_depth -= 1

    def on_dispatch(self, step: int, warmup: bool = False) -> None:
        """Per-call hook of the train, predict and serving loops: heartbeat
        and compile drain, host work only.  ``warmup`` marks calls where a
        build or a capture is expected, so steady-state ones are separable."""
        with self._lock:
            warmup = warmup or self._warmup_depth > 0
        self.heartbeat(step)
        delta = self._sentinel.drain()
        hits = self._sentinel.drain_cache_hits()
        self._last_warmup = bool(warmup)
        if delta or hits:
            with self._lock:
                self.compiles_total += delta
                if not warmup:
                    self.compiles_steady += delta
            self.emit(
                "compile",
                step=step,
                source=self.source,
                compiles=delta,
                total_compiles=self.compiles_total,
                warmup=bool(warmup),
                cache_hits=hits,
            )

    def emit_mem(self, step: int | None = None) -> None:
        self.emit("mem", step=step, **self._mem.sample())

    def emit_anomaly(
        self, step: int, loss, event: str = "nonfinite_loss", state=None, **fields
    ) -> None:
        """A structured divergence record: step, loss and, given the state,
        the first non-finite tensor's name."""
        with self._lock:
            self.anomalies += 1
        if state is not None and "first_nonfinite" not in fields:
            fields["first_nonfinite"] = first_nonfinite_leaf(state)
        self.emit(
            "anomaly",
            step=step,
            event=event,
            loss=None if loss is None else float(loss),
            **fields,
        )

    # -- the monitor's thread ---------------------------------------------

    def _watch(self) -> None:
        polls = [self._stall_timeout / 4.0] if self._stall_timeout > 0 else []
        if self._mem_every_s > 0:
            polls.append(self._mem_every_s)
        poll = max(0.02, min(min(polls), 1.0))
        while not self._stop.wait(poll):
            if self._mem_every_s > 0:
                now = time.monotonic()
                if now - self._last_mem >= self._mem_every_s:
                    self._last_mem = now
                    try:
                        self.emit_mem()
                    except (OSError, ValueError):
                        pass  # a full metrics disk must not kill the thread
            if self._stall_timeout > 0:
                self._check_stall()

    def _probe(self, fn):
        if fn is None:
            return None
        try:
            return fn()
        # analysis: ok exception-hygiene caller-injected probe; the watchdog must survive any probe bug — None still classifies
        except Exception:
            return None

    def _check_stall(self) -> None:
        with self._lock:
            if self._last_beat is None or self._suspended:
                return  # not armed yet / in a no-dispatch phase
            since = time.monotonic() - self._last_beat
            fired = self._stall_fired
            step = self._step
        if since < self._stall_timeout or fired:
            return
        stacks = thread_stacks()
        stacks.pop("telemetry-watchdog", None)  # our own frame is noise
        compiling = compiling_now(stacks)
        if compiling and since < 10.0 * self._stall_timeout:
            return  # a build or capture in progress: re-check next poll
        with self._lock:
            self._stall_fired = True
            self.stalls += 1
        depth = self._probe(self._queue_depth_fn)
        alive = self._probe(self._producer_alive_fn)
        idle = self._probe(self._stream_idle_fn)
        cls = "compiling" if compiling else classify_stall(depth, stacks, alive, idle)
        try:
            self.emit(
                "stall",
                step=step,
                deadline_s=self._stall_timeout,
                since_last_step_s=round(since, 3),
                classification=cls,
                prefetch_queue_depth=depth,
                producer_alive=alive,
                stacks=stacks,
            )
        except (OSError, ValueError):
            pass  # a full metrics disk must not kill stall detection
        log_quietly(
            self._log,
            f"telemetry watchdog: no step for {since:.1f}s "
            f"(deadline {self._stall_timeout:.1f}s) at step {step} — "
            f"{cls}; thread stacks -> kind=stall record",
        )

    # -- shutdown ---------------------------------------------------------

    def close(self, **summary_fields) -> None:
        """Final drain (compiles no call drained, inheriting the last call's
        warm-up framing), the last memory watermark and the kind=summary
        totals; extra keyword fields merge into the summary.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
        delta = self._sentinel.drain()
        hits = self._sentinel.drain_cache_hits()
        if delta or hits:
            warm = self._last_warmup
            with self._lock:
                self.compiles_total += delta
                if not warm:
                    self.compiles_steady += delta
            self.emit(
                "compile",
                source=self.source,
                compiles=delta,
                total_compiles=self.compiles_total,
                warmup=warm,
                cache_hits=hits,
            )
        self.emit_mem()
        self.emit(
            "summary",
            total_compiles=self.compiles_total,
            steady_compiles=self.compiles_steady,
            stalls=self.stalls,
            anomalies=self.anomalies,
            **summary_fields,
        )
        if self._own_logger:
            self._logger.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the hang-exit watchdog ------------------------------------------------

DEFAULT_HANG_EXIT_SECS = 600.0


def arm_hang_exit(seconds: float = DEFAULT_HANG_EXIT_SECS, what: str = "bench"):
    """Hard hang watchdog for batch tools: ``os._exit(2)`` with a stderr
    note unless cancelled within ``seconds``.  Returns the armed
    ``threading.Timer`` (``.cancel()`` it on success).  Unlike the
    RunMonitor's watchdog (observe, classify, keep running) this one kills:
    a batch tool has nothing to salvage from a wedged device."""

    def fire():
        print(
            f"{what} watchdog: no result after {seconds:.0f}s — the device "
            "appears hung; aborting without a number",
            file=sys.stderr,
            flush=True,
        )
        os._exit(2)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t
