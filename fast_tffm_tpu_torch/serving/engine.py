"""The in-process serving engine: admission → micro-batch → bucket → score.

The counterpart of ``fast_tffm_tpu/serving/engine.py``.  Request
lifecycle:

  1. ``submit_line`` / ``submit`` parses one request to the static
     ``max_nnz`` width; ``submit_block`` takes a whole decoded REQUEST
     frame (protocol.py) as one unit: one queue slot, one coalesced
     placement, one ``(statuses, scores)`` answer with per-row typed
     codes.  Both enqueue on the bounded admission queue
     (``serve_overload``: ``block`` applies backpressure, ``reject``
     raises OverloadError; ``serve_classes`` tiers shed lower classes
     first).
  2. The collector thread flushes when ``serve_max_batch`` rows are
     pending or ``serve_flush_deadline_ms`` expires for the oldest one.
  3. A flush sheds rows whose own deadline passed, cuts lumpy pending
     lists into groups of at most ``max_batch`` rows, pads each up to the
     nearest bucket (buckets.BucketLadder), stages it in one host→device
     copy, scores on the device, and resolves the futures.
  4. Hot reload (``serve_reload_interval_s`` > 0, or ``reload_once`` from
     a replica's router): a changed ``model_file`` is staged OFF the hot
     path, either a full restore or, while the base is the one loaded,
     the new delta files applied to a private copy of the table
     (``_apply_delta_state``; the live table is never written, a flush
     may be reading it).  The reload thread waits for that work on the
     device before staging, and the collector swaps the staged state in
     between flushes, so every flush scores one whole checkpoint.  A torn
     or mid-write file fails the stage (counted, retried with backoff,
     given up after ``serve_reload_max_retries`` until a new write) and
     never touches the serving state.

Telemetry: each engine owns a ``telemetry.RunMonitor`` (``metrics_path``,
``source = serving``) and writes a ``kind=serving`` metrics snapshot every
``serve_metrics_every_s`` and at close, and one ``kind=freshness`` record
per swap (publish → applied at the swap, publish → first scored flush);
the warm-up's kernel builds count as warm-up compiles, any later one as
steady-state, and with ``profile_costs`` each bucket gets one kind=profile
record.  There is no stall watchdog: an idle engine is healthy.

One process, one device: the deployment unit the router (router.py)
replicates.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import (
    checkpoint_save_id,
    checkpoint_signature,
    load_delta,
    read_delta_chain,
    read_publish_time,
)
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.data.libsvm import parse_lines, scan_max_nnz
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.ops.packed_table import scatter_logical_rows
from fast_tffm_tpu_torch.profiling import CostLedger
from fast_tffm_tpu_torch.serving.admission import AdmissionQueue
from fast_tffm_tpu_torch.serving.buckets import BucketLadder
from fast_tffm_tpu_torch.serving.metrics import ServingMetrics
from fast_tffm_tpu_torch.serving.protocol import FRAME_STATUS_CODES, DeadlineExceeded
from fast_tffm_tpu_torch.telemetry import RunMonitor, log_quietly

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


class EngineClosed(RuntimeError):
    """Request submitted to (or unresolved inside) a closed engine."""


_CLOSE = object()  # collector shutdown sentinel

# Per-row status bytes of block (frame) answers: indices into
# protocol.FRAME_STATUS_CODES, so the wire and the engine agree by
# construction.
_ST_OK = 0
_ST_OVERLOADED = FRAME_STATUS_CODES.index("overloaded")
_ST_DEADLINE = FRAME_STATUS_CODES.index("deadline")
_ST_BAD_REQUEST = FRAME_STATUS_CODES.index("bad_request")
_ST_UNAVAILABLE = FRAME_STATUS_CODES.index("unavailable")


@dataclass
class _Request:
    row: tuple  # (ids [max_nnz] i32, vals [max_nnz] f32, fields [max_nnz] i32)
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    klass: str = ""  # client class name ("" = default tier)
    tier: int = 0  # admission tier (higher sheds later; from serve_classes)
    deadline_t: float | None = None  # perf_counter deadline; None = none

    n_rows = 1  # admission and flush row accounting (a block carries many)


@dataclass
class _Block:
    """A whole decoded REQUEST frame admitted as ONE unit.  ``future``
    resolves to ``(statuses u8[n], scores f32[n])``; nonzero statuses index
    FRAME_STATUS_CODES, so per-row typed errors survive batching.  Its tier
    is the minimum over its rows: under tiered overload a mixed frame sheds
    as its weakest member."""

    ids: np.ndarray  # (n, max_nnz) i32
    vals: np.ndarray  # (n, max_nnz) f32
    fields: np.ndarray | None  # (n, max_nnz) i32, or None
    deadline_t: np.ndarray  # (n,) f64 perf_counter deadlines; +inf = none
    statuses: np.ndarray  # (n,) u8; nonzero = decided before scoring
    klasses: list  # per-row class names (metrics attribution)
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)
    klass: str = ""  # representative class ("" when mixed)
    tier: int = 0

    @property
    def n_rows(self) -> int:
        return int(self.ids.shape[0])


class ServingEngine:
    """See module docstring.  ``device`` is where scoring runs: None means
    ``cuda`` and raises without a CUDA device; tests pass ``"cpu"``.
    ``state`` / ``model`` inject a scoring state instead of restoring
    ``model_file``; ``replica`` stamps the telemetry records of a router's
    replica."""

    def __init__(
        self, cfg: Config, log=print, state=None, model=None, device=None,
        replica: int | None = None,
    ):
        from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn

        self._cfg = cfg
        self._log = log
        self.device = resolve_device(device)
        max_nnz = scan_max_nnz(cfg)
        cfg.check_width(max_nnz)
        if state is None:
            # The reload signature and the chain baseline are read BEFORE the
            # restore: a save landing mid-restore must read as new to the
            # watcher (at worst it reloads what was just restored), and an
            # under-counted chain only re-applies deltas in order, which is
            # idempotent.
            self._loaded_sig = checkpoint_signature(cfg.model_file)
            self._loaded_save_id, self._applied_deltas = self._chain_baseline()
            model, state = load_scoring_state(cfg, log, device=self.device)
        elif state.table.device.type != self.device.type:
            raise ValueError(f"state lives on {state.table.device}, engine on {self.device}")
        else:
            # Injected state: nothing on disk was loaded, so whatever
            # model_file holds is news to the watcher.
            self._loaded_sig = None
            self._loaded_save_id, self._applied_deltas = None, 0
        if cfg.serve_reload_interval_s > 0 and state.layout == "fused":
            # A reload restores plain-packed (load_scoring_state), whose
            # gather is not the fused one this score function was built for:
            # a swap would score a D-stride table with D+1-stride arithmetic.
            raise ValueError(
                "hot reload (serve_reload_interval_s > 0) cannot re-pack "
                "checkpoints into an injected fused-packed state's layout; "
                "pass a plain-packed/rows state, or disable the watcher"
            )
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
        # Latency injection (a replica's `slow` op): the next `_slow_flushes`
        # flushes sleep `_slow_ms` before dispatch.
        self._slow_ms = 0.0
        self._slow_flushes = 0
        self._last_flush_t = time.perf_counter()
        self.metrics = ServingMetrics()
        self._monitor = RunMonitor(
            cfg.metrics_path or None, run_id=cfg.telemetry_run_id, source="serving",
            mem_every_s=cfg.telemetry_mem_every_s, replica=replica, device=self.device,
            log=log,
        )
        self._flush_seq = 0  # the serving records' step: the flush ordinal
        self._metrics_every = cfg.serve_metrics_every_s
        self._last_metrics_log = time.perf_counter()
        self._closed = False  # no new submits (set by close AND by a collector crash)
        self._close_done = False  # close() finalization ran
        self._stop = threading.Event()
        # Hot-reload handoff: a reload tick STAGES a complete state here and
        # the collector SWAPS it in between flushes.
        self._reload_lock = threading.Lock()
        # Whole ticks serialize on this lock: a second caller (the router's
        # reload racing the poll, two router commands) queues behind a tick
        # mid-apply and then sees the advanced chain, so deltas apply in
        # chain order.
        self._tick_lock = threading.Lock()
        self._staged_state = None
        self._staged_step = None
        self._staged_is_delta = False
        # Freshness: the staged checkpoint's publish stamp travels with the
        # stage; the swap seals publish→applied and the first scored flush
        # after it publish→first-scored.
        self._staged_pub_t = None
        self._pending_fresh = None
        # Failure discipline for ONE observed signature: exponential backoff,
        # and after serve_reload_max_retries failures a give-up until a NEW
        # write lands.
        self._fail_sig = None
        self._fail_count = 0
        self._gave_up = False
        self._next_retry_t = 0.0
        try:
            self._ladder.warmup(self._state)
        except BaseException:
            self._monitor.close()
            raise
        if cfg.telemetry_profile_costs:
            ledger = CostLedger(self._monitor)
            for bucket in self._ladder.buckets:
                ledger.stage(f"serve_score_b{bucket}", examples=bucket)
            ledger.flush(0)
        # Every start-up build is warm-up; anything after is steady-state.
        self._monitor.on_dispatch(0, warmup=True)
        log(
            f"serving: warmed buckets {self._ladder.buckets} on {self.device} "
            f"(max_nnz {max_nnz}, flush deadline {cfg.serve_flush_deadline_ms}ms, "
            f"queue {cfg.serve_queue_size} {self._policy})"
        )
        self._collector = threading.Thread(
            target=self._collect, name="serve-collector", daemon=True
        )
        self._collector.start()
        self._watcher = None
        if cfg.serve_reload_interval_s > 0:
            self._watcher = threading.Thread(
                target=self._watch, name="serve-reload", daemon=True
            )
            self._watcher.start()

    # -- submission ------------------------------------------------------

    @property
    def buckets(self) -> tuple[int, ...]:
        return self._ladder.buckets

    @property
    def run_id(self) -> str:
        """Telemetry run id of this engine's monitor."""
        return self._monitor.run_id

    @property
    def step(self) -> int:
        """Step of the state serving now (it advances at the first flush
        after a reload swap, not when a tick stages)."""
        return int(self._state.step)

    @property
    def max_nnz(self) -> int:
        """Static per-row width: what a binary-wire client packs frames at."""
        return self._score.max_nnz

    @property
    def uses_fields(self) -> bool:
        """Whether the model reads the fields section (FFM)."""
        return bool(self._score.uses_fields)

    def compile_count(self) -> int:
        """Kernel builds this engine's monitor saw (the port's compiles; 0
        when every kernel library was already in ``_build/``)."""
        return self._monitor.compiles_total

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
        ``deadline_at`` (a ``time.monotonic()`` timestamp: the front end
        anchors the budget at wire receipt) wins over both.  A request
        still unscored at its deadline fails with DeadlineExceeded before
        it can pad a bucket."""
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

    def submit_block(self, ids, vals, fields=None, *, deadlines_ms=None, classes=None) -> Future:
        """Submit a whole decoded REQUEST frame as ONE admission unit.

        ``ids``/``vals`` (and optional ``fields``) are (n, width) arrays
        with width <= max_nnz (column-padded here); ``deadlines_ms`` are
        per-row budgets anchored now (0 = serve_deadline_ms).  Returns a
        Future of ``(statuses, scores)``: u8 codes into FRAME_STATUS_CODES
        and float32 rows.  Frame-level shape errors raise ValueError (a
        typed bad_request at the wire); a row with an out-of-range id fails
        alone with bad_request status."""
        ids = np.asarray(ids, np.int32)
        vals = np.asarray(vals, np.float32)
        w = self._score.max_nnz
        if ids.ndim != 2 or vals.shape != ids.shape:
            raise ValueError(
                f"block ids/vals must be matching (n, width) arrays, got "
                f"{ids.shape} / {vals.shape}"
            )
        n, width = ids.shape
        if n < 1:
            raise ValueError("empty block")
        if n > self.max_batch:
            raise ValueError(
                f"block of {n} rows exceeds max_batch {self.max_batch}: "
                "honor the negotiated max_frame_rows"
            )
        if width > w:
            raise ValueError(f"block width {width} exceeds max_nnz {w}")
        if fields is not None:
            fields = np.asarray(fields, np.int32)
            if fields.shape != ids.shape:
                raise ValueError(f"fields shape {fields.shape} != ids shape {ids.shape}")
        if width < w:
            pad = ((0, 0), (0, w - width))
            ids = np.pad(ids, pad)
            vals = np.pad(vals, pad)
            if fields is not None:
                fields = np.pad(fields, pad)
        v = self._cfg.vocabulary_size
        bad = ((ids < 0) | (ids >= v)).any(axis=1)
        statuses = np.where(bad, np.uint8(_ST_BAD_REQUEST), np.uint8(_ST_OK))
        if classes is None:
            klasses = [""] * n
        else:
            klasses = [str(c or "") for c in classes]
            if len(klasses) != n:
                raise ValueError(f"classes carries {len(klasses)} entries for {n} rows")
        t_submit = time.perf_counter()
        base = self._default_deadline_s
        base_t = (t_submit + base) if (base is not None and base > 0) else np.inf
        if deadlines_ms is None:
            deadline_t = np.full(n, base_t)
        else:
            d = np.asarray(deadlines_ms, np.float64).reshape(-1)
            if d.shape != (n,):
                raise ValueError(f"deadlines_ms carries {d.shape} entries for {n} rows")
            deadline_t = np.where(d > 0, t_submit + d / 1e3, base_t)
        block = _Block(
            ids=ids,
            vals=vals,
            fields=fields,
            deadline_t=deadline_t,
            statuses=statuses,
            klasses=klasses,
            t_submit=t_submit,
            klass=klasses[0] if len(set(klasses)) == 1 else "",
            tier=min(self._tiers.get(k, 0) for k in klasses),
        )
        self._admit(
            block,
            lambda ok: self.metrics.on_submit_many(n, accepted=ok, klasses=klasses),
        )
        return block.future

    def _shed_evicted(self, evicted: "_Request | _Block | None") -> None:
        """Fail an evicted request's future with the typed overload error;
        an evicted block resolves instead, its rows flipped to overloaded."""
        if evicted is None:
            return
        if isinstance(evicted, _Block):
            if evicted.future.set_running_or_notify_cancel():
                st = evicted.statuses.copy()
                st[st == _ST_OK] = _ST_OVERLOADED
                evicted.future.set_result((st, np.zeros(evicted.n_rows, np.float32)))
            for k in evicted.klasses:
                self.metrics.on_evict(k)
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
            # The remaining monotonic budget in this engine's perf_counter
            # terms (may already be <= 0: the flush then sheds it).
            req.deadline_t = req.t_submit + (deadline_at - time.monotonic())
        else:
            dl = self._default_deadline_s if deadline_ms is None else deadline_ms / 1e3
            if dl is not None and dl > 0:
                req.deadline_t = req.t_submit + dl
        self._admit(req, lambda ok: self.metrics.on_submit(accepted=ok, klass=klass))
        return req.future

    def _admit(self, item: "_Request | _Block", count) -> None:
        """Enqueue under the overload policy; ``count(accepted)`` records
        the outcome in the metrics."""
        if self._closed:
            raise EngineClosed("engine is closed")
        if self._policy == "reject":
            try:
                self._shed_evicted(self._q.put_nowait(item, tier=item.tier))
            except queue.Full:
                count(False)
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
                    self._shed_evicted(self._q.put(item, tier=item.tier, timeout=0.1))
                    break
                except queue.Full:
                    continue
        count(True)
        # Close race: if close() finished its drain between our closed-check
        # and our enqueue, nobody will pop this request — drain it ourselves.
        if self._closed and not self._collector.is_alive():
            self._drain_with_exception(EngineClosed("engine closed"))

    # -- collector -------------------------------------------------------

    def _collect(self) -> None:
        pending: list[_Request | _Block] = []
        rows = 0  # real rows across `pending` (a block counts its n)
        deadline = 0.0
        draining = False
        try:
            while True:
                if pending and rows >= self.max_batch:
                    self._flush(pending, deadline_fired=False)
                    pending, rows = [], 0
                    continue
                timeout = None
                if pending:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        # Top up with already-queued requests first: under
                        # backlog the oldest deadline is often past when it
                        # is popped, and flushing it alone would collapse
                        # micro-batching exactly when load is highest.
                        while rows < self.max_batch:
                            try:
                                extra = self._q.get_nowait()
                            except queue.Empty:
                                break
                            if extra is _CLOSE:
                                draining = True
                                break
                            pending.append(extra)
                            rows += extra.n_rows
                        self._flush(pending, deadline_fired=rows < self.max_batch)
                        pending, rows = [], 0
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
                rows += item.n_rows
        except BaseException as e:  # never strand submitted futures
            # Closed first: a block-policy submit would otherwise spin on a
            # queue nobody drains; the watcher stops too.
            self._closed = True
            self._stop.set()
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

    def _flush(self, pending: "list[_Request | _Block]", deadline_fired: bool) -> None:
        # The atomic reload swap: flushes are the only readers of _state, so
        # swapping here makes every request of this flush (and of all later
        # ones) score against one whole checkpoint.
        with self._reload_lock:
            staged, self._staged_state = self._staged_state, None
            staged_step = self._staged_step
            staged_is_delta = self._staged_is_delta
            staged_pub_t = self._staged_pub_t
        if staged is not None:
            self._state = staged
            if staged_pub_t is not None:
                # publish→applied is sealed HERE (the swap is the apply);
                # publish→first-scored completes at this flush or, if it
                # scores nothing, a later one.
                self._pending_fresh = {
                    "published_at": staged_pub_t,
                    "applied_ms": max(0.0, (time.time() - staged_pub_t) * 1e3),
                    "step": staged_step,
                    "mode": "delta" if staged_is_delta else "full",
                }
            if not staged_is_delta:
                # Delta swaps are counted per FILE by on_delta_reload:
                # `reloads` counts full re-reads only.
                self.metrics.on_reload(ok=True)
            log_quietly(self._log, f"serving: swapped in checkpoint step {staged_step}")
        # Blocks make the pending row counts lumpy (a close-time drain or a
        # block-heavy top-up can pass max_batch, which has no bucket): cut
        # into groups of at most max_batch rows.  One block never exceeds
        # max_batch (submit_block enforces it).
        chunk: list[_Request | _Block] = []
        chunk_rows = 0
        for item in pending:
            if chunk and chunk_rows + item.n_rows > self.max_batch:
                self._flush_units(chunk, deadline_fired)
                chunk, chunk_rows = [], 0
            chunk.append(item)
            chunk_rows += item.n_rows
        if chunk:
            self._flush_units(chunk, deadline_fired)

    def _flush_units(self, pending: "list[_Request | _Block]", deadline_fired: bool) -> None:
        # Claim the futures: this filters out requests cancelled by their
        # callers and blocks late cancels (resolving a cancelled future raises).
        pending = [r for r in pending if r.future.set_running_or_notify_cancel()]
        # Deadline shed BEFORE padding: an expired request only inflates the
        # bucket for an answer nobody waits for, and shedding first can
        # shrink the bucket the survivors pad to.
        now = time.perf_counter()
        reqs: list[_Request] = []  # live per-row requests, in order
        blocks: list[tuple[_Block, np.ndarray]] = []  # (block, alive rows)
        n_alive = 0
        for r in pending:
            if isinstance(r, _Block):
                st = r.statuses
                expired = (now >= r.deadline_t) & (st == _ST_OK)
                if expired.any():
                    st[expired] = _ST_DEADLINE
                    for i in np.flatnonzero(expired):
                        self.metrics.on_deadline_drop(r.klasses[int(i)])
                alive = np.flatnonzero(st == _ST_OK)
                blocks.append((r, alive))
                n_alive += int(alive.size)
                continue
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
                n_alive += 1
        if n_alive == 0:
            # Every row shed: blocks still owe their one answer.  This is
            # progress too (the router's wedge check reads the flush age).
            for b, _ in blocks:
                b.future.set_result((b.statuses, np.zeros(b.n_rows, np.float32)))
            self._last_flush_t = time.perf_counter()
            return
        if self._slow_flushes > 0:  # injected latency (the `slow` op)
            self._slow_flushes -= 1
            time.sleep(self._slow_ms / 1e3)
        t_start = time.perf_counter()
        try:
            parts = [(r.row[0][None], r.row[1][None], r.row[2][None]) for r in reqs]
            parts += [
                (b.ids[alive], b.vals[alive], b.fields[alive] if b.fields is not None else None)
                for b, alive in blocks
            ]
            batch, bucket = self._ladder.assemble_parts(parts)
            t_dispatch = time.perf_counter()
            scores = self._ladder.score(self._state, batch).cpu().numpy()
            t_done = time.perf_counter()
        except BaseException as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            for b, alive in blocks:
                if not b.future.done():
                    # Blocks resolve, never raise: decided rows keep their
                    # codes, the would-have-scored rows become unavailable.
                    st = b.statuses.copy()
                    st[alive] = _ST_UNAVAILABLE
                    b.future.set_result((st, np.zeros(b.n_rows, np.float32)))
            log_quietly(self._log, f"serving: flush failed: {e!r}")
            self._last_flush_t = time.perf_counter()
            return
        pos = 0
        for r in reqs:
            r.future.set_result(float(scores[pos]))
            pos += 1
        for b, alive in blocks:
            out = np.zeros(b.n_rows, np.float32)
            out[alive] = scores[pos : pos + alive.size]
            pos += int(alive.size)
            b.future.set_result((b.statuses, out))
        t_resolved = time.perf_counter()
        self._flush_seq += 1
        if self._pending_fresh is not None:
            self._emit_freshness()
        try:
            self._monitor.on_dispatch(self._flush_seq)
        except (OSError, ValueError):
            pass  # a telemetry write failure is a lost record, never a dead collector
        self._last_flush_t = t_resolved
        # One metrics group per request plus one per block (a frame's rows
        # share their submit and resolve instants).
        self.metrics.on_flush(
            bucket,
            n_alive,
            queue_waits=[t_start - r.t_submit for r in reqs]
            + [t_start - b.t_submit for b, _ in blocks],
            compute_s=t_done - t_dispatch,
            total_s=[t_resolved - r.t_submit for r in reqs]
            + [t_resolved - b.t_submit for b, _ in blocks],
            deadline_fired=deadline_fired,
            classes=[r.klass for r in reqs] + [b.klass for b, _ in blocks],
            counts=[1] * len(reqs) + [int(alive.size) for _, alive in blocks],
        )
        if self._metrics_every > 0 and t_resolved - self._last_metrics_log >= self._metrics_every:
            self._last_metrics_log = t_resolved
            try:
                self.metrics.log_to(self._monitor)
            except (OSError, ValueError):
                pass  # a full metrics disk must not kill the collector

    def _emit_freshness(self) -> None:
        """Seal one reload's freshness: publish→applied was measured at the
        swap, publish→first-scored completes now.  Collector thread only."""
        f, self._pending_fresh = self._pending_fresh, None
        scored_ms = max(0.0, (time.time() - f["published_at"]) * 1e3)
        self.metrics.on_freshness(f["applied_ms"] / 1e3, scored_ms / 1e3)
        try:
            self._monitor.emit(
                "freshness",
                step=self._flush_seq,
                publish_step=f["step"],
                publish_to_applied_ms=round(f["applied_ms"], 3),
                publish_to_first_scored_ms=round(scored_ms, 3),
                mode=f["mode"],
            )
        except (OSError, ValueError):
            pass  # a full metrics disk must not kill the collector

    # -- hot reload ------------------------------------------------------

    def _chain_baseline(self) -> tuple[str | None, int]:
        """(base save_id, delta-chain length) of the checkpoint on disk,
        tolerant of anything unreadable (None/0 keeps the delta path off
        until the next full reload)."""
        path = self._cfg.model_file
        if os.path.isdir(path):
            return None, 0
        try:
            sid = checkpoint_save_id(path)
            _, chain = read_delta_chain(path)
            return sid, len(chain)
        except (ValueError, OSError):
            return checkpoint_save_id(path), 0

    def _apply_delta_state(self, state, delta):
        """One delta applied to a COPY of ``state``: the logical rows
        written into a clone of the (rows or plain-packed) table, the dense
        leaves replaced, the step advanced.  The live table is never
        written: the collector may be mid-flush on it.  (Accumulators are
        not carried: scoring reads none, and a full reload replaces them.)"""
        from fast_tffm_tpu_torch.weights import _tensor

        table = state.table
        idx = delta["idx"]
        keep = idx < self._cfg.vocabulary_size  # a restore trims rows past it too
        if keep.any():
            ids = torch.from_numpy(np.ascontiguousarray(idx[keep])).to(table.device)
            rows = torch.from_numpy(
                np.ascontiguousarray(delta["table_rows"][keep], dtype=np.float32)
            ).to(table.device)
            if state.layout == "packed":
                table = scatter_logical_rows(table, ids, rows, self._score.model.row_dim)
            else:
                table = table.clone()
                table[ids] = rows
        dense = state.dense
        if dense:
            dense = [_tensor(np.asarray(x), table.device) for x in delta["dense"]]
        return dataclasses.replace(state, table=table, dense=dense, step=int(delta["step"]))

    def _try_apply_deltas(self):
        """In-place incremental reload: while the base on disk is the one
        this engine loaded and only new delta files landed, apply the
        unapplied suffix to a copy of the serving state and return
        (staged_state, n_applied).  None when the base changed (a full
        reload is needed), (None, 0) when nothing is new."""
        base_sig, chain = read_delta_chain(self._cfg.model_file)
        if self._loaded_save_id is None or base_sig != self._loaded_save_id:
            return None
        new = chain[self._applied_deltas :]
        if not new:
            return (None, 0)
        state = self._state
        n_dense = len(state.dense)
        for meta in new:
            state = self._apply_delta_state(state, load_delta(meta["path"], n_dense))
        return (state, len(new))

    def _note_reload_failure(self, sig, what, exc) -> None:
        """Failure discipline for ONE observed signature: retries back off
        exponentially from the poll interval, and after
        serve_reload_max_retries consecutive failures the engine gives up
        on that signature (reload_giveups + one kind=anomaly record).  A
        NEW write resets it."""
        self.metrics.on_reload(ok=False)
        if sig != self._fail_sig:
            self._fail_sig, self._fail_count, self._gave_up = sig, 0, False
        self._fail_count += 1
        backoff = min(
            max(self._cfg.serve_reload_interval_s, 0.01) * (2.0 ** self._fail_count), 60.0
        )
        self._next_retry_t = time.monotonic() + backoff
        log_quietly(
            self._log,
            f"serving: {what} of {self._cfg.model_file} failed "
            f"(attempt {self._fail_count}/{self._cfg.serve_reload_max_retries}, "
            f"next retry in {backoff:.2f}s): {exc!r}",
        )
        if self._fail_count >= self._cfg.serve_reload_max_retries:
            self._gave_up = True
            self.metrics.on_reload_giveup()
            try:
                self._monitor.emit_anomaly(
                    self.step, None, event="reload_giveup",
                    path=self._cfg.model_file, error=repr(exc), attempts=self._fail_count,
                )
            except (OSError, ValueError):
                pass  # a full metrics disk must not kill the watcher
            log_quietly(
                self._log,
                f"serving: giving up on this checkpoint write after "
                f"{self._fail_count} failed reloads; serving continues on the "
                "loaded state and a NEW write will be retried",
            )

    def _reload_tick(self) -> str:
        """One reload attempt: check the signature, stage a new state if one
        landed.  The polling watcher's loop body and ``reload_once``.
        Returns ``noop`` | ``staged`` | ``staged_delta`` | ``failed`` |
        ``backoff`` | ``busy``."""
        with self._tick_lock:
            with self._reload_lock:
                if self._staged_state is not None:
                    # The collector has not swapped the last stage yet;
                    # applying deltas onto _state now would drop it.
                    return "busy"
            sig = checkpoint_signature(self._cfg.model_file)
            if sig is None or sig == self._loaded_sig:
                return "noop"
            if sig == self._fail_sig:
                if self._gave_up or time.monotonic() < self._next_retry_t:
                    return "backoff"
            else:
                self._fail_sig, self._fail_count, self._gave_up = None, 0, False
            with self._monitor.warmup_window():
                return self._reload_attempt(sig)

    def _reload_attempt(self, sig) -> str:
        """The restore or apply of one tick, off the hot path (the collector
        keeps flushing the old state meanwhile)."""
        from fast_tffm_tpu_torch.prediction import load_scoring_state

        # The freshness stamp names the chain head seen at the START: a
        # publish landing mid-restore can only make the measured staleness
        # larger, the safe direction.
        pub_t = read_publish_time(self._cfg.model_file)
        state = None
        applied = 0
        if not os.path.isdir(self._cfg.model_file):
            try:
                got = self._try_apply_deltas()
            except Exception as e:
                # A torn or mid-write delta: counted, the serving state
                # untouched, retried with backoff.
                self._note_reload_failure(sig, "delta reload", e)
                return "failed"
            if got == (None, 0):
                # The signature moved without new chain content.
                self._loaded_sig = sig
                return "noop"
            if got is not None:
                state, applied = got
        if state is None:
            new_sid, new_applied = self._chain_baseline()  # PRE-restore, as above
            try:
                _, state = load_scoring_state(
                    self._cfg, log=lambda *_: None, device=self.device
                )
            except Exception as e:
                self._note_reload_failure(sig, "reload", e)
                return "failed"
            self._loaded_save_id = new_sid
            self._applied_deltas = new_applied
        else:
            self._applied_deltas += applied
            self.metrics.on_delta_reload(applied)
        if self.device.type == "cuda":
            # The restore's or apply's kernels complete before the collector
            # can swap the state in and launch flushes on it.
            torch.cuda.current_stream(self.device).synchronize()
        self._fail_sig, self._fail_count, self._gave_up = None, 0, False
        self._loaded_sig = sig
        with self._reload_lock:
            self._staged_state = state
            self._staged_step = int(state.step)
            self._staged_is_delta = applied > 0
            self._staged_pub_t = pub_t
        return "staged_delta" if applied > 0 else "staged"

    def reload_once(self) -> dict:
        """One reload tick on the caller's thread: how a replica applies the
        router's fanned-out ``reload``.  With a router the engine's own
        watcher is off, so each write is applied once per replica."""
        status = self._reload_tick()
        return {"status": status, "step": self.step}

    def _watch(self) -> None:
        while not self._stop.wait(self._cfg.serve_reload_interval_s):
            self._reload_tick()

    # -- health / chaos / shutdown -------------------------------------------

    def inject_slow(self, ms: float, flushes: int = 1) -> None:
        """Make the next ``flushes`` flushes sleep ``ms`` before dispatch:
        a degraded replica, without touching real scoring."""
        self._slow_ms = float(ms)
        self._slow_flushes = int(flushes)

    def health(self) -> dict:
        """O(1) liveness probe: queue depth, age of the oldest queued
        request, time since the last completed flush (the router's wedge
        signal), whether the engine still accepts."""
        now = time.perf_counter()
        oldest = self._q.oldest_wait_s(now)
        return {
            "ok": not self._closed,
            "closed": self._closed,
            "step": self.step,
            "queue_depth": self._q.qsize(),
            "oldest_wait_s": round(oldest, 4) if oldest is not None else None,
            "last_flush_age_s": round(now - self._last_flush_t, 4),
            "steady_compiles": self._monitor.compiles_steady,
        }

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting, flush everything already admitted, stop the
        threads, write the final metrics record.  Idempotent."""
        if self._close_done:
            return
        self._close_done = True
        self._closed = True
        self._stop.set()
        # The sentinel bypasses the admission bound, so a full queue cannot
        # block close().
        self._q.put_sentinel(_CLOSE)
        self._collector.join(timeout=timeout)
        # A submit that raced this close may have enqueued after the
        # collector's exit drain — fail it rather than strand the caller.
        self._drain_with_exception(EngineClosed("engine closed"))
        if self._watcher is not None:
            self._watcher.join(timeout=timeout)
        try:
            self.metrics.log_to(self._monitor)  # the final snapshot
        except (OSError, ValueError):
            pass
        finally:
            self._monitor.close()

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
        f"p50/p99 total {snap['total_ms'].get('p50')}/{snap['total_ms'].get('p99')}ms, "
        f"reloads {snap['reloads']}"
    )
    return snap
