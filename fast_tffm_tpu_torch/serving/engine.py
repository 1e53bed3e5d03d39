"""The in-process serving engine: admission → micro-batch → bucket → score.

The counterpart of ``fast_tffm_tpu/serving/engine.py``'s core.  Request
lifecycle:

  1. ``submit_line`` / ``submit`` parses the request to the static
     ``max_nnz`` width and enqueues it on the bounded admission queue
     (``serve_overload``: ``block`` applies backpressure, ``reject``
     raises OverloadError; ``serve_classes`` tiers shed lower classes
     first).
  2. The collector thread flushes when ``serve_max_batch`` rows are
     pending or ``serve_flush_deadline_ms`` expires for the oldest one.
  3. A flush sheds requests whose own deadline passed, pads the rest up to
     the nearest bucket (buckets.BucketLadder), stages them in one
     host→device copy, scores on the device, and resolves the futures.

One process, one device.  Later slices of the port add hot reload and
delta chains, block (binary frame) submission, chaos injection and the
RunMonitor telemetry; until then ``serve_reload_interval_s > 0`` is
refused at construction.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.libsvm import parse_lines, scan_max_nnz
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.serving.admission import AdmissionQueue
from fast_tffm_tpu_torch.serving.buckets import BucketLadder
from fast_tffm_tpu_torch.serving.metrics import ServingMetrics

__all__ = [
    "ServingEngine",
    "OverloadError",
    "DeadlineExceeded",
    "EngineClosed",
    "serve_lines",
]


class OverloadError(RuntimeError):
    """Admission queue full under serve_overload = reject, or a queued
    request evicted by a higher-class arrival (tiered admission)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before it could be scored."""


class EngineClosed(RuntimeError):
    """Request submitted to (or unresolved inside) a closed engine."""


_CLOSE = object()  # collector shutdown sentinel


def _log_quietly(log, msg: str) -> None:
    """Log from the collector thread; a failing log sink must not kill it."""
    try:
        log(msg)
    except (OSError, ValueError):
        pass


@dataclass
class _Request:
    row: tuple  # (ids [max_nnz] i32, vals [max_nnz] f32, fields [max_nnz] i32)
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    klass: str = ""  # client class name ("" = default tier)
    tier: int = 0  # admission tier (higher sheds later; from serve_classes)
    deadline_t: float | None = None  # perf_counter deadline; None = none


class ServingEngine:
    """See module docstring.  ``device`` is where scoring runs: None means
    ``cuda`` and raises without a CUDA device; tests pass ``"cpu"``."""

    def __init__(self, cfg: Config, log=print, state=None, model=None, device=None):
        from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn

        if cfg.serve_reload_interval_s > 0:
            raise ValueError(
                "serve_reload_interval_s > 0: hot checkpoint reload is not ported "
                "yet (a later slice of fast_tffm_tpu_torch); set it to 0"
            )
        self._cfg = cfg
        self._log = log
        self.device = resolve_device(device)
        max_nnz = scan_max_nnz(cfg)
        if state is None:
            model, state = load_scoring_state(cfg, log, device=self.device)
        elif state.table.device.type != self.device.type:
            raise ValueError(f"state lives on {state.table.device}, engine on {self.device}")
        self._state = state
        self._score = make_score_fn(cfg, state, max_nnz, model=model)
        self._ladder = BucketLadder(self._score, cfg.serve_buckets, device=self.device)
        self.max_batch = cfg.serve_max_batch or self._ladder.max_batch
        self.deadline_s = cfg.serve_flush_deadline_ms / 1e3
        self._policy = cfg.serve_overload
        self._q = AdmissionQueue(cfg.serve_queue_size)
        self._tiers = dict(cfg.serve_classes)
        self._default_deadline_s = (
            cfg.serve_deadline_ms / 1e3 if cfg.serve_deadline_ms > 0 else None
        )
        self._last_flush_t = time.perf_counter()
        self.metrics = ServingMetrics()
        self._closed = False  # no new submits (set by close AND by a collector crash)
        self._close_done = False  # close() finalization ran
        self._ladder.warmup(self._state)
        log(
            f"serving: warmed buckets {self._ladder.buckets} on {self.device} "
            f"(max_nnz {max_nnz}, flush deadline {cfg.serve_flush_deadline_ms}ms, "
            f"queue {cfg.serve_queue_size} {self._policy})"
        )
        self._collector = threading.Thread(
            target=self._collect, name="serve-collector", daemon=True
        )
        self._collector.start()

    # -- submission ------------------------------------------------------

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._ladder.buckets

    @property
    def step(self) -> int:
        return int(self._state.step)

    @property
    def max_nnz(self) -> int:
        return self._score.max_nnz

    def submit_line(
        self,
        line: str,
        *,
        klass: str = "",
        deadline_ms: float | None = None,
        deadline_at: float | None = None,
    ) -> Future:
        """Submit one libsvm/libffm line (``label feat:val ...``; the label
        is required by the grammar and ignored).  Returns a Future of the
        float score.  Malformed lines and rows wider than max_nnz raise
        ValueError here.

        ``klass`` names the client class (tier from serve_classes; unknown
        = tier 0, shed first).  ``deadline_ms`` is this request's budget
        from submit time (None = serve_deadline_ms; 0 disables);
        ``deadline_at`` (a ``time.monotonic()`` timestamp) wins over both.
        A request still unscored at its deadline fails with
        DeadlineExceeded before it can pad a bucket."""
        parsed = parse_lines(
            [line],
            vocabulary_size=self._cfg.vocabulary_size,
            hash_feature_id_flag=self._cfg.hash_feature_id,
            max_nnz=self._score.max_nnz,
        )
        return self._submit_row(
            (parsed.ids[0].astype(np.int32, copy=False), parsed.vals[0], parsed.fields[0]),
            klass=klass,
            deadline_ms=deadline_ms,
            deadline_at=deadline_at,
        )

    def submit(
        self,
        ids,
        vals,
        fields=None,
        *,
        klass: str = "",
        deadline_ms: float | None = None,
        deadline_at: float | None = None,
    ) -> Future:
        """Submit one pre-parsed example (1-D ids/vals[/fields], up to
        max_nnz entries; zero-padded here)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        vals = np.asarray(vals, np.float32).reshape(-1)
        w = self._score.max_nnz
        if ids.shape != vals.shape or ids.size > w:
            raise ValueError(
                f"ids/vals must match and carry <= max_nnz={w} entries, "
                f"got {ids.shape} / {vals.shape}"
            )
        v = self._cfg.vocabulary_size
        if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= v):
            # Torch indexing would raise mid-flush (CPU) or fault the device
            # (CUDA); the range is the caller's contract, checked here.
            raise ValueError(
                f"feature ids must lie in [0, {v}); got [{int(ids.min())}, {int(ids.max())}]"
            )
        fields = (
            np.zeros(ids.shape, np.int32)
            if fields is None
            else np.asarray(fields, np.int32).reshape(-1)
        )
        if fields.shape != ids.shape:
            raise ValueError(f"fields shape {fields.shape} != ids shape {ids.shape}")
        pad = w - ids.size
        if pad:
            ids = np.pad(ids, (0, pad))
            vals = np.pad(vals, (0, pad))
            fields = np.pad(fields, (0, pad))
        return self._submit_row(
            (ids, vals, fields), klass=klass, deadline_ms=deadline_ms, deadline_at=deadline_at
        )

    def _shed_evicted(self, evicted: "_Request | None") -> None:
        """Fail an evicted request's future with the typed overload error."""
        if evicted is None:
            return
        if evicted.future.set_running_or_notify_cancel():
            evicted.future.set_exception(
                OverloadError(
                    f"shed: evicted by a higher-class arrival under overload "
                    f"(class {evicted.klass or 'default'!r}, tier {evicted.tier})"
                )
            )
        self.metrics.on_evict(evicted.klass)

    def _submit_row(
        self,
        row,
        *,
        klass: str = "",
        deadline_ms: float | None = None,
        deadline_at: float | None = None,
    ) -> Future:
        req = _Request(row, klass=klass, tier=self._tiers.get(klass, 0))
        if deadline_at is not None:
            req.deadline_t = req.t_submit + (deadline_at - time.monotonic())
        else:
            dl = self._default_deadline_s if deadline_ms is None else deadline_ms / 1e3
            if dl is not None and dl > 0:
                req.deadline_t = req.t_submit + dl
        if self._closed:
            raise EngineClosed("engine is closed")
        if self._policy == "reject":
            try:
                self._shed_evicted(self._q.put_nowait(req, tier=req.tier))
            except queue.Full:
                self.metrics.on_submit(accepted=False, klass=klass)
                raise OverloadError(
                    f"admission queue full ({self._q.maxsize} pending) — "
                    "overload; shed load or raise serve_queue_size / switch "
                    "serve_overload to block"
                ) from None
        else:  # block: backpressure, re-checking closure so a shutdown
            # mid-overload cannot strand the caller.
            while True:
                if self._closed:
                    raise EngineClosed("engine closed while blocked on admission")
                try:
                    self._shed_evicted(self._q.put(req, tier=req.tier, timeout=0.1))
                    break
                except queue.Full:
                    continue
        self.metrics.on_submit(accepted=True, klass=klass)
        # Close race: if close() finished its drain between our closed-check
        # and our enqueue, nobody will pop this request — drain it ourselves.
        if self._closed and not self._collector.is_alive():
            self._drain_with_exception(EngineClosed("engine closed"))
        return req.future

    # -- collector -------------------------------------------------------

    def _collect(self) -> None:
        pending: list[_Request] = []
        deadline = 0.0
        draining = False
        try:
            while True:
                if len(pending) >= self.max_batch:
                    self._flush(pending, deadline_fired=False)
                    pending = []
                    continue
                timeout = None
                if pending:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        # Top up with already-queued requests first: under
                        # backlog the oldest deadline is often past when it
                        # is popped, and flushing it alone would collapse
                        # micro-batching exactly when load is highest.
                        while len(pending) < self.max_batch:
                            try:
                                extra = self._q.get_nowait()
                            except queue.Empty:
                                break
                            if extra is _CLOSE:
                                draining = True
                                break
                            pending.append(extra)
                        self._flush(pending, deadline_fired=len(pending) < self.max_batch)
                        pending = []
                        continue
                elif draining:
                    return
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    continue
                if item is _CLOSE:
                    draining = True
                    deadline = time.perf_counter()  # expire immediately
                    continue
                if not pending:
                    # The deadline anchors at the oldest request's SUBMIT time.
                    deadline = item.t_submit + self.deadline_s
                pending.append(item)
        except BaseException as e:  # never strand submitted futures
            self._closed = True
            for r in pending:
                if not r.future.done():
                    r.future.set_exception(e)
            self._drain_with_exception(e)
            raise
        finally:
            self._drain_with_exception(EngineClosed("engine closed"))

    def _drain_with_exception(self, exc: BaseException) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _CLOSE and not item.future.done():
                item.future.set_exception(exc)

    def _flush(self, pending: list[_Request], deadline_fired: bool) -> None:
        """Score ``pending`` in groups of at most ``max_batch`` rows."""
        for i in range(0, len(pending), self.max_batch):
            self._flush_units(pending[i : i + self.max_batch], deadline_fired)

    def _flush_units(self, pending: list[_Request], deadline_fired: bool) -> None:
        # Claim the futures: this filters out requests cancelled by their
        # callers and blocks late cancels (resolving a cancelled future raises).
        pending = [r for r in pending if r.future.set_running_or_notify_cancel()]
        # Deadline shed BEFORE padding: an expired request only inflates the
        # bucket for an answer nobody waits for.
        now = time.perf_counter()
        reqs: list[_Request] = []
        for r in pending:
            if r.deadline_t is not None and now >= r.deadline_t:
                r.future.set_exception(
                    DeadlineExceeded(
                        f"deadline expired {1e3 * (now - r.deadline_t):.1f}ms "
                        f"before scoring (waited {1e3 * (now - r.t_submit):.1f}ms)"
                    )
                )
                self.metrics.on_deadline_drop(r.klass)
            else:
                reqs.append(r)
        if not reqs:
            self._last_flush_t = time.perf_counter()  # answered = progress
            return
        t_start = time.perf_counter()
        try:
            parts = [(r.row[0][None], r.row[1][None], r.row[2][None]) for r in reqs]
            batch, bucket = self._ladder.assemble_parts(parts)
            t_dispatch = time.perf_counter()
            scores = self._ladder.score(self._state, batch).cpu().numpy()
            t_done = time.perf_counter()
        except BaseException as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            _log_quietly(self._log, f"serving: flush failed: {e!r}")
            self._last_flush_t = time.perf_counter()
            return
        for pos, r in enumerate(reqs):
            r.future.set_result(float(scores[pos]))
        t_resolved = time.perf_counter()
        self._last_flush_t = t_resolved
        self.metrics.on_flush(
            bucket,
            len(reqs),
            queue_waits=[t_start - r.t_submit for r in reqs],
            compute_s=t_done - t_dispatch,
            total_s=[t_resolved - r.t_submit for r in reqs],
            deadline_fired=deadline_fired,
            classes=[r.klass for r in reqs],
        )

    # -- health / shutdown -------------------------------------------------

    def health(self) -> dict:
        """O(1) liveness probe: queue depth, age of the oldest queued
        request, time since the last completed flush, whether the engine
        still accepts."""
        now = time.perf_counter()
        oldest = self._q.oldest_wait_s(now)
        return {
            "ok": not self._closed,
            "closed": self._closed,
            "step": self.step,
            "queue_depth": self._q.qsize(),
            "oldest_wait_s": round(oldest, 4) if oldest is not None else None,
            "last_flush_age_s": round(now - self._last_flush_t, 4),
        }

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, flush everything already admitted, stop the
        collector.  Idempotent."""
        if self._close_done:
            return
        self._close_done = True
        self._closed = True
        # The sentinel bypasses the admission bound, so a full queue cannot
        # block close().
        self._q.put_sentinel(_CLOSE)
        self._collector.join(timeout=timeout)
        # A submit that raced this close may have enqueued after the
        # collector's exit drain — fail it rather than strand the caller.
        self._drain_with_exception(EngineClosed("engine closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_lines(cfg: Config, lines=None, out=None, log=print, device=None) -> dict:
    """The ``serve`` verb in pipe mode: stream libsvm lines (default stdin)
    through a ServingEngine on ``device``, writing one ``%.6f`` score per
    input line in input order.  A bounded window of futures keeps memory
    flat on any input length; under serve_overload = reject the writer
    drains a result and retries, so no line is dropped.  Returns the
    engine's final metrics snapshot."""
    import sys
    from collections import deque

    lines = sys.stdin if lines is None else lines
    out = sys.stdout if out is None else out
    window: deque = deque()
    n = 0

    def write_next(block: bool = True) -> bool:
        nonlocal n
        if not window or (not block and not window[0].done()):
            return False
        out.write(f"{window.popleft().result():.6f}\n")
        n += 1
        return True

    with ServingEngine(cfg, log=log, device=device) as engine:
        cap = max(4 * engine.max_batch, 1024)
        for line in lines:
            line = line.strip()
            if not line:
                continue
            while True:
                try:
                    window.append(engine.submit_line(line))
                    break
                except OverloadError:
                    if not write_next():
                        time.sleep(engine.deadline_s or 0.001)
            # In-order opportunistic drain: a live stream sees each score as
            # soon as it resolves, not in cap-sized bursts at EOF.
            wrote = False
            while write_next(block=False):
                wrote = True
            while len(window) >= cap:
                wrote = write_next() or wrote
            if wrote:
                out.flush()
        while write_next():
            pass
        out.flush()
        snap = engine.metrics_snapshot()
    log(
        f"served {n} scores: occupancy {snap['batch_occupancy']}, "
        f"p50/p99 total {snap['total_ms'].get('p50')}/{snap['total_ms'].get('p99')}ms"
    )
    return snap
