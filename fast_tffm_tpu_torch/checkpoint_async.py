"""Async and incremental checkpointing — the counterpart of
``fast_tffm_tpu/checkpoint_async.py`` for one process and one device.

  * **Async full saves** (``async_save``): at a save boundary the loop takes
    a device snapshot — a ``clone()`` of every state tensor, queued on the
    compute stream before the next step or graph replay is launched, since
    the tail kernels and a K-step replay update the live tensors in place —
    records an event behind it and resumes training.  A writer thread
    waits on that event on its own CUDA stream, converts the snapshot to
    the logical arrays (``saveable``: a packed or fused state unpacks),
    copies them to the host chunk by chunk through one pinned buffer of
    ``chunk_bytes`` and publishes with tmp + ``os.replace``.  At most one
    save is in flight: the next boundary waits for the writer (counted as
    back-pressure).  The stop, final and abort saves stay synchronous.
  * **Delta saves** (``delta_every_steps``): a device bitmap over the
    vocabulary marks the rows each call touched (``note_batch``, one
    ``index_fill_`` behind the step on the same stream); a delta boundary
    reads the window's rows back, gathers their logical table and
    accumulator rows from the live layout (new tensors, queued before the
    next launch) and clones the dense leaves, and the writer ships a
    ``delta-NNNN`` file chained to its base by content signature
    (``checkpoint.save_delta``).  The chain is compacted into a full save
    by ``delta_chain_max``, ``full_every_s`` and ``chain_max_bytes``.

  * **Tiered runs** (``paramstore``, a ``TieredParamServer``): every
    boundary is synchronous and spans both tiers.  A full save flushes the
    writeback, publishes one npz with the hot tier, the residency and every
    pending row (``paramstore.ckpt.write_tiered_full``), then applies
    pending to the cold store; a delta save gathers the window's touched
    hot slots off the device (the bitmap is over the compact capacity's
    slots), translates them to logical ids, adds the pending rows and
    publishes them through ``save_delta``, then applies.  Publish before
    apply is crash-consistency invariant 7.

  * **Multi-process runs** (``runtime``, an active
    ``distributed.DistributedRuntime``): the single-writer npz protocol.
    At every boundary every rank posts its input cursor and joins the
    collectives (``saveable``, the gather of the logical state onto rank
    0; a delta's ``touched_rows``, the ranks' bitmaps OR-ed and the
    touched rows gathered onto rank 0), dispatched on the loop's side;
    rank 0 alone writes, embedding the per-rank cursor vector (``hosts``),
    and posts each publish's outcome (its content signature, or
    ``failed``).  Every other rank waits on that outcome — at once for a
    synchronous save, at its next boundary for an async or delta one (the
    writer's own one-in-flight back-pressure) — and mirrors the chain
    bookkeeping from it, so the promote-to-full decision is the same on
    every rank.  The age and size compaction (``full_every_s``,
    ``chain_max_bytes``) is off: a wall-clock threshold read on each rank
    could disagree.

Every save emits a ``kind=ckpt`` record (``mode`` full / delta / sync, its
snapshot, convert, D2H and write times, bytes, rows and the train loop's
stall) through the RunMonitor.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import uuid

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import (
    DEFAULT_CHUNK_BYTES,
    latest_step,
    read_delta_chain,
    save_checkpoint,
    save_delta,
)
from fast_tffm_tpu_torch.resilience import maybe_torn_delta
from fast_tffm_tpu_torch.telemetry import log_quietly

__all__ = ["AsyncCheckpointer", "device_snapshot", "gather_rows"]


def device_snapshot(state):
    """A copy of the raw state's tensors on their device, queued on the
    current stream: the next in-place step cannot reach it.  Returns the
    state copy and, on the card, an event recorded behind the copies."""
    snap = dataclasses.replace(
        state,
        table=state.table.clone(),
        table_accum=None if state.table_accum is None else state.table_accum.clone(),
        dense=[p.clone() for p in state.dense],
        dense_accum=[a.clone() for a in state.dense_accum],
    )
    return snap, _record(state.table.device)


def _record(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def gather_rows(state, idx, d: int):
    """The logical rows of the logical ids ``idx`` (row width ``d``) and
    their accumulator rows, straight from the live layout (no unpack of the
    table), as new tensors."""
    from fast_tffm_tpu_torch.ops.packed_table import (
        fused_accum_gather,
        fused_gather,
        packed_accum_gather_any,
        packed_gather,
    )

    if state.layout == "rows":
        return state.table[idx], state.table_accum[idx]
    if state.layout == "fused":
        return fused_gather(state.table, idx, d), fused_accum_gather(state.table, idx, d)
    return packed_gather(state.table, idx, d), packed_accum_gather_any(state.table_accum, idx, d)


class AsyncCheckpointer:
    """Owns the save boundaries of one training run (see the module
    docstring).  The training loop calls, in its order: ``note_batch`` after every
    call (delta mode), ``delta_due``/``delta_boundary`` at step boundaries,
    ``save_boundary`` at epoch saves, and ``finalize`` then a synchronous
    ``save_boundary(sync=True)`` on the way out.  Writer failures are
    counted and logged, never raised into the loop: the previous checkpoint
    stays the last good state."""

    def __init__(
        self,
        path: str,
        *,
        device,
        monitor=None,
        log=print,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        async_save: bool = False,
        delta_every_steps: int = 0,
        delta_chain_max: int = 16,
        full_every_s: float = 0.0,
        chain_max_bytes: int = 0,
        vocab: int = 0,
        row_dim: int = 0,
        start_step: int = 0,
        cursor_fn=None,
        paramstore=None,
        runtime=None,
        touched_rows=None,
    ):
        self._path = path
        self._device = torch.device(device)
        self._monitor = monitor
        self._log = log
        self._chunk = int(chunk_bytes)
        # A tiered run's saves are synchronous: the store apply must follow
        # the npz publish (config.validate refuses async_save with it).
        self._ps = paramstore
        self._rt = runtime if (runtime is not None and runtime.active) else None
        self._is_writer = self._rt is None or self._rt.is_lead
        self._seq = 0  # save boundaries so far: the same on every rank
        self._pending_await: int | None = None  # a non-writer's unawaited publish
        self._async = bool(async_save) and paramstore is None
        self._delta_every = int(delta_every_steps)
        self._chain_max = max(1, int(delta_chain_max))
        self._full_every_s = float(full_every_s) if self._rt is None else 0.0
        self._chain_bytes_max = int(chain_max_bytes) if self._rt is None else 0
        self._last_full_t = time.monotonic()
        self._chain_bytes = 0
        self._vocab = int(vocab)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._last_boundary_step = int(start_step)
        self._cursor_fn = cursor_fn
        cuda = self._device.type == "cuda"
        # The writer's stream and its pinned staging buffer (the host-side
        # bound of every save's device-to-host copies), made here on the
        # loop's thread.
        # High priority: never a graph's default capture stream (a pooled
        # default-priority stream can be; data/wire.py says why it matters).
        self._side = torch.cuda.Stream(self._device, priority=-1) if cuda else None
        self._staging = (torch.empty(self._chunk, dtype=torch.uint8, pin_memory=True)
                         if cuda else None)
        self._bitmap = None
        self._row_dim = int(row_dim)
        # ``touched_rows(state, bitmap) -> (idx, table rows, accum rows)``
        # is a delta's rows (the mesh's gather under dist_train; rows None
        # on a rank that does not write).
        self._touched_rows = touched_rows or self._local_touched_rows
        # A resumed run extends the chain it restored from (its head step
        # equals our start step; anything else is another history).  A
        # fresh run has no parent: its first delta boundary is a full save.
        self._parent_sig = None
        self._next_seq = 1
        self._chain_len = 0
        if self._delta_every > 0 and int(start_step) > 0:
            try:
                on_disk = latest_step(path)
                base_sig, chain = read_delta_chain(path)
            except (ValueError, OSError):
                on_disk, base_sig, chain = None, None, []
            if on_disk == int(start_step):
                if chain:
                    self._parent_sig = chain[-1]["save_id"]
                    self._next_seq = len(chain) + 1
                    self._chain_len = len(chain)
                    self._chain_bytes = sum(
                        os.path.getsize(m["path"]) for m in chain if os.path.isfile(m["path"])
                    )
                else:
                    self._parent_sig = base_sig
        self.full_saves = 0
        self.delta_saves = 0
        self.sync_saves = 0
        self.write_failures = 0
        self.cursor_failures = 0
        self.blocked_boundaries = 0
        self.blocked_ms = 0.0

    # -- loop-side hooks --------------------------------------------------

    @property
    def delta_enabled(self) -> bool:
        return self._delta_every > 0

    def note_batch(self, b) -> None:
        """OR what one call touched into the bitmap (delta mode only): ``b``
        its logical ids (a tensor on the run's device)."""
        if self._delta_every <= 0:
            return
        if self._bitmap is None:
            self._bitmap = self._fresh_bitmap()
        self._bitmap.index_fill_(0, b.reshape(-1).long(), True)

    def _local_touched_rows(self, state, bitmap):
        idx = torch.nonzero(bitmap).reshape(-1)  # sorted, one sync
        return (idx, *gather_rows(state, idx, self._row_dim))

    def delta_due(self, step: int) -> bool:
        return self._delta_every > 0 and step - self._last_boundary_step >= self._delta_every

    def _fresh_bitmap(self):
        return torch.zeros(self._vocab, dtype=torch.bool, device=self._device)

    def _cursor(self) -> dict | None:
        if self._cursor_fn is None:
            return None
        try:
            return self._cursor_fn()
        # analysis: ok exception-hygiene a cursor bug must never cost the checkpoint; counted and logged, saved without a cursor
        except Exception as e:
            with self._lock:
                self.cursor_failures += 1
            log_quietly(self._log, f"cursor capture failed (saving without one): {e!r}")
            return None

    # -- the multi-process protocol -----------------------------------------

    def _merged_cursor(self, seq: int) -> dict | None:
        """The cursor boundary ``seq`` embeds.  Multi-process: every rank
        posts its cursor; the lead embeds the vector (``hosts[p]``: rank
        p's position), the JAX member layout."""
        cursor = self._cursor()
        if self._rt is None:
            return cursor
        vec = self._rt.share_cursor(seq, cursor)
        if vec is None:  # a non-lead rank posted its own
            return cursor
        merged = dict(cursor or {})
        merged["process_count"] = self._rt.process_count
        merged["hosts"] = [{"process": p, "epoch": (c or {}).get("epoch"),
                            "batch_in_epoch": (c or {}).get("batch_in_epoch")}
                           for p, c in enumerate(vec)]
        return merged

    def _publish_outcome(self, seq: int, sid: str | None, meta: str) -> None:
        """The lead: post boundary ``seq``'s outcome (``sid`` durable, or
        ``failed``), from whichever thread published."""
        if self._rt is None or not self._is_writer:
            return
        try:
            self._rt.publish_signature(seq, sid, meta)
        # analysis: ok exception-hygiene a dead store means the pod is coming apart; the peers surface it as PeerLostError, the writer logs and goes on
        except Exception as e:
            log_quietly(self._log, f"checkpoint signature publish failed: {e!r}")

    def _apply_outcome(self, out: dict | None) -> None:
        """A non-writer's mirror of the lead's chain bookkeeping, from one
        awaited outcome: the promote-to-full decision must be the same on
        every rank."""
        if out is None:
            return
        sid, meta = out.get("sig"), out.get("meta")
        with self._lock:
            if meta == "full" and sid:
                self._parent_sig, self._next_seq, self._chain_len = sid, 1, 0
            elif meta == "delta" and sid:
                self._parent_sig = sid
                self._next_seq += 1
                self._chain_len += 1
            else:  # a failed write: the lead's promote-to-full reset
                self._parent_sig = None

    def _await_pending(self, count: bool = False) -> None:
        """A non-writer's back-pressure point: block until the previous
        publish's outcome is posted (the save barrier of an async or delta
        boundary), as the lead's own drain waits out its writer."""
        if self._pending_await is None:
            return
        t0 = time.perf_counter()
        seq, self._pending_await = self._pending_await, None
        self._apply_outcome(self._rt.await_signature(seq))
        blocked = (time.perf_counter() - t0) * 1e3
        if count and blocked > 1.0:
            self.blocked_boundaries += 1
            self.blocked_ms += blocked

    # -- boundaries -------------------------------------------------------

    def save_boundary(self, state, saveable, step: int, *, sync: bool = False,
                      emit: bool = True) -> None:
        """Full save: async (snapshot + writer thread) unless ``sync`` or
        ``async_save`` is off.  Multi-process: every rank dispatches the
        collective ``saveable``; only rank 0 writes."""
        t0 = time.perf_counter()
        self._drain(count=True)
        self._await_pending(count=True)
        if self._delta_every > 0:
            # A full save supersedes the accumulated window either way.
            self._bitmap = self._fresh_bitmap() if self._bitmap is not None else None
            self._last_boundary_step = int(step)
        self._seq += 1
        seq = self._seq
        cursor = self._merged_cursor(seq)
        if self._ps is not None:
            return self._tiered_full(state, step, cursor, t0, emit)
        sid = uuid.uuid4().hex
        if sync or not self._async:
            logical = saveable(state)  # multi-process: the gather onto rank 0
            if not self._is_writer:
                # The save barrier: on only once the lead's publish is durable.
                self._apply_outcome(self._rt.await_signature(seq))
                return
            t1 = time.perf_counter()
            timings: dict = {}
            try:
                nbytes = save_checkpoint(self._path, logical, chunk_bytes=self._chunk,
                                         save_id=sid, cursor=cursor, timings=timings,
                                         staging=self._staging)
            except Exception:
                with self._lock:
                    self.write_failures += 1
                self._publish_outcome(seq, None, "failed")
                raise  # a synchronous save failing must surface: it is the last line
            self._on_full_published(sid)
            self._publish_outcome(seq, sid, "full")
            self.sync_saves += 1
            if emit:
                self._emit("sync", step, timings, nbytes=nbytes, rows=logical.table.shape[0],
                           snapshot_ms=0.0, convert_ms=(t1 - t0) * 1e3,
                           train_stall_ms=(time.perf_counter() - t0) * 1e3)
            return
        snap, ready = device_snapshot(state)
        convert = saveable
        if self._rt is not None:
            # The gather is a collective every rank dispatches here, on the
            # loop's side; the lead's writer thread only copies and writes.
            snap, convert = saveable(snap), None
            ready = _record(self._device)
            if not self._is_writer:
                self._pending_await = seq
                return
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._spawn(self._write_full, (snap, ready, convert, int(step), sid, stall_ms, emit,
                                       cursor, seq))

    def delta_boundary(self, state, saveable, step: int) -> None:
        """Delta save of the touched window; promotes itself to a full save
        when there is no signed base yet or the chain is long, old or fat.
        Multi-process: every rank ORs its bitmap into the union and joins
        the rows' gather; only rank 0 writes."""
        t0 = time.perf_counter()
        self._drain(count=True)
        self._await_pending(count=True)
        with self._lock:
            parent_sig, chain_len = self._parent_sig, self._chain_len
            chain_bytes, last_full_t = self._chain_bytes, self._last_full_t
        if (
            parent_sig is None
            or chain_len >= self._chain_max
            or (self._full_every_s > 0 and time.monotonic() - last_full_t >= self._full_every_s)
            or (self._chain_bytes_max > 0 and chain_bytes >= self._chain_bytes_max)
        ):
            return self.save_boundary(state, saveable, step)
        if self._ps is not None:
            return self._tiered_delta(state, step, t0)
        self._seq += 1
        seq = self._seq
        bitmap = self._bitmap if self._bitmap is not None else self._fresh_bitmap()
        idx_dev, trows, arows = self._touched_rows(state, bitmap)
        self._bitmap = self._fresh_bitmap()
        self._last_boundary_step = int(step)
        dense = [p.clone() for p in state.dense]
        dacc = [a.clone() for a in state.dense_accum]
        ready = _record(self._device)
        idx = idx_dev.cpu().numpy()
        with self._lock:
            link, parent = self._next_seq, self._parent_sig
        cursor = self._merged_cursor(seq)
        if not self._is_writer:
            self._pending_await = seq  # the rows' gather was this rank's share
            return
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._spawn(self._write_delta, (link, parent, idx, trows, arows, dense, dacc, ready,
                                        int(state.step), int(step), stall_ms, cursor, seq))

    # -- tiered boundaries (paramstore; synchronous) -----------------------

    def _tiered_full(self, state, step, cursor, t0, emit) -> None:
        """Full save over both tiers: flush the writeback, publish one npz
        (``write_tiered_full``), then apply pending to the store."""
        from fast_tffm_tpu_torch.paramstore.ckpt import write_tiered_full

        sid = uuid.uuid4().hex
        self._ps.flush_writeback(state)
        pending_rows = self._ps.pending_rows
        t1 = time.perf_counter()
        try:
            nbytes = write_tiered_full(self._path, self._ps, state, int(step), save_id=sid,
                                       cursor=cursor, chunk_bytes=self._chunk,
                                       staging=self._staging)
        except Exception:
            with self._lock:
                self.write_failures += 1
            raise  # tiered saves are synchronous: a failure must surface
        self._on_full_published(sid)
        self._apply_tiered(sid)
        self.sync_saves += 1
        if emit:
            self._emit("sync", step, {}, nbytes=nbytes, rows=self._ps.hot_rows + pending_rows,
                       snapshot_ms=0.0, convert_ms=(t1 - t0) * 1e3,
                       train_stall_ms=(time.perf_counter() - t0) * 1e3)

    def _tiered_delta(self, state, step, t0) -> None:
        """Delta save over both tiers: the window's touched hot slots
        gathered off the device and translated to logical ids, plus the
        pending rows (after the flush, so the last call's staged rows are
        in it), through ``save_delta``; then the apply.  Hot and pending
        rows are disjoint (a resident row never misses)."""
        cursor = self._cursor()
        self._ps.flush_writeback(state)
        if self._bitmap is not None:
            slots = torch.nonzero(self._bitmap).reshape(-1)
        else:
            slots = torch.zeros(0, dtype=torch.int64, device=self._device)
        self._bitmap = self._fresh_bitmap()
        self._last_boundary_step = int(step)
        hot_slots = slots[slots < self._ps.hot_rows]
        trows = state.table[hot_slots].cpu().numpy()
        arows = state.table_accum[hot_slots].cpu().numpy()
        hot_ids = self._ps.hot_logical_ids(hot_slots.cpu().numpy())
        pend_ids, pend_t, pend_a = self._ps.pending_snapshot()
        idx = np.concatenate([hot_ids, pend_ids]).astype(np.int64)
        with self._lock:
            seq, parent = self._next_seq, self._parent_sig
        stall_ms = (time.perf_counter() - t0) * 1e3
        timings: dict = {}
        try:
            out, sid, nbytes = save_delta(
                self._path, seq, idx=idx, table_rows=np.concatenate([trows, pend_t]),
                accum_rows=np.concatenate([arows, pend_a]),
                dense_leaves=list(state.dense), dense_accum_leaves=list(state.dense_accum),
                step=int(state.step), parent_sig=parent, chunk_bytes=self._chunk,
                timings=timings, cursor=cursor, staging=self._staging,
            )
            maybe_torn_delta(out)
        # analysis: ok exception-hygiene the writer's boundary, as the async writer's: counted, logged, the chain intact and the next boundary promoted to full
        except Exception as e:
            self._on_write_failed()
            log_quietly(self._log, f"tiered delta write failed (chain intact): {e!r}")
            return
        with self._lock:
            self._parent_sig = sid
            self._next_seq = seq + 1
            self._chain_len += 1
            self._chain_bytes += int(nbytes)
            self.delta_saves += 1
        self._apply_tiered(sid)
        self._emit("delta", step, timings, nbytes=nbytes, rows=int(idx.size),
                   snapshot_ms=stall_ms, convert_ms=0.0, train_stall_ms=stall_ms)

    def _apply_tiered(self, sid: str) -> None:
        """The post-publish store apply.  A failure never unpublishes:
        pending stays and rides (and applies after) the next boundary."""
        try:
            self._ps.apply_pending(sid)
        # analysis: ok exception-hygiene the apply's boundary: the publish stands, pending is kept for the next boundary, counted and logged
        except Exception as e:
            with self._lock:
                self.write_failures += 1
            log_quietly(self._log, "paramstore apply failed after publish (pending rows "
                        f"retained; chain intact): {e!r}")

    # -- writer thread ----------------------------------------------------

    def _spawn(self, fn, args) -> None:
        self._thread = threading.Thread(target=fn, args=args, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _drain(self, count: bool = False) -> float:
        """Back-pressure point: wait out the (at most one) in-flight writer.
        Returns the blocked milliseconds."""
        t = self._thread
        if t is None:
            return 0.0
        self._thread = None
        if not t.is_alive():
            t.join()
            return 0.0
        t0 = time.perf_counter()
        t.join()
        blocked = (time.perf_counter() - t0) * 1e3
        if count:
            self.blocked_boundaries += 1
            self.blocked_ms += blocked
        return blocked

    def finalize(self) -> None:
        """Join any in-flight write, so an older async publish can never
        land after (and clobber) the final synchronous one; a non-writer
        rank awaits its outstanding publish the same way."""
        self._drain()
        self._await_pending()

    def _on_writer_stream(self, ready):
        """The writer's stream, waiting on ``ready`` (the snapshot's event);
        a no-op context on the CPU."""
        if self._side is None:
            return contextlib.nullcontext()
        self._side.wait_event(ready)
        return torch.cuda.stream(self._side)

    def _sync_writer_stream(self) -> None:
        if self._side is not None:
            self._side.synchronize()

    def _write_full(self, snap, ready, saveable, step, sid, stall_ms, emit, cursor,
                    seq) -> None:
        try:
            with self._on_writer_stream(ready):
                t0 = time.perf_counter()
                logical = saveable(snap) if saveable is not None else snap
                self._sync_writer_stream()
                convert_ms = (time.perf_counter() - t0) * 1e3
                timings: dict = {}
                nbytes = save_checkpoint(self._path, logical, chunk_bytes=self._chunk,
                                         save_id=sid, cursor=cursor, timings=timings,
                                         staging=self._staging)
            self._on_full_published(sid)
            self._publish_outcome(seq, sid, "full")
            with self._lock:
                self.full_saves += 1
            if emit:
                self._emit("full", step, timings, nbytes=nbytes, rows=logical.table.shape[0],
                           snapshot_ms=stall_ms, convert_ms=convert_ms,
                           train_stall_ms=stall_ms)
        # analysis: ok exception-hygiene the writer thread's boundary: counted, logged, the previous checkpoint stays the last good state
        except Exception as e:
            self._on_write_failed()
            self._publish_outcome(seq, None, "failed")
            log_quietly(self._log,
                        f"async checkpoint write failed (previous checkpoint intact): {e!r}")

    def _write_delta(self, seq, parent, idx, trows, arows, dense, dacc, ready, state_step,
                     step, stall_ms, cursor, bseq) -> None:
        try:
            with self._on_writer_stream(ready):
                t0 = time.perf_counter()
                self._sync_writer_stream()
                convert_ms = (time.perf_counter() - t0) * 1e3
                timings: dict = {}
                out, sid, nbytes = save_delta(
                    self._path, seq, idx=idx, table_rows=trows, accum_rows=arows,
                    dense_leaves=dense, dense_accum_leaves=dacc, step=state_step,
                    parent_sig=parent, chunk_bytes=self._chunk, timings=timings,
                    cursor=cursor, staging=self._staging,
                )
                # The torn_delta@K injection point: truncates the file just
                # published, the torn write a crash leaves on a non-atomic
                # filesystem (the chain repair's case).
                maybe_torn_delta(out)
            with self._lock:
                self._parent_sig = sid
                self._next_seq = seq + 1
                self._chain_len += 1
                self._chain_bytes += int(nbytes)
                self.delta_saves += 1
            self._publish_outcome(bseq, sid, "delta")
            self._emit("delta", step, timings, nbytes=nbytes, rows=int(idx.size),
                       snapshot_ms=stall_ms, convert_ms=convert_ms, train_stall_ms=stall_ms)
        # analysis: ok exception-hygiene the writer thread's boundary: counted, logged, the chain stays intact and the next boundary promotes to full
        except Exception as e:
            self._on_write_failed()
            self._publish_outcome(bseq, None, "failed")
            log_quietly(self._log, f"delta checkpoint write failed (chain intact): {e!r}")

    def _on_full_published(self, sid: str) -> None:
        with self._lock:
            self._parent_sig = sid
            self._next_seq = 1
            self._chain_len = 0
            self._chain_bytes = 0
            self._last_full_t = time.monotonic()

    def _on_write_failed(self) -> None:
        """A failed write dropped its window's rows (the boundary already
        reset the bitmap), so later deltas alone can no longer rebuild the
        state: clear the parent, forcing the next delta boundary to promote
        itself to a full save.  The on-disk base and chain stay loadable."""
        with self._lock:
            self.write_failures += 1
            self._parent_sig = None

    # -- telemetry --------------------------------------------------------

    def _emit(self, mode, step, timings, *, nbytes, rows, snapshot_ms, convert_ms,
              train_stall_ms) -> None:
        if self._monitor is None:
            return
        try:
            self._monitor.emit(
                "ckpt",
                step=int(step),
                mode=mode,
                snapshot_ms=round(float(snapshot_ms), 3),
                convert_ms=round(float(convert_ms), 3),
                d2h_ms=round(float(timings.get("d2h_ms", 0.0)), 3),
                write_ms=round(float(timings.get("write_ms", 0.0)), 3),
                bytes=int(nbytes or 0),
                rows_written=int(rows),
                train_stall_ms=round(float(train_stall_ms), 3),
            )
        except (OSError, ValueError):
            pass  # a full metrics disk must not cost the checkpoint

    def summary(self) -> dict:
        """End-of-run counters, merged into the kind=summary record."""
        with self._lock:
            out = {
                "ckpt_full_saves": self.full_saves,
                "ckpt_delta_saves": self.delta_saves,
                "ckpt_sync_saves": self.sync_saves,
                "ckpt_write_failures": self.write_failures,
                "ckpt_cursor_failures": self.cursor_failures,
                "ckpt_blocked_boundaries": self.blocked_boundaries,
            }
        if self.blocked_ms:
            out["ckpt_blocked_ms"] = round(self.blocked_ms, 3)
        return {k: v for k, v in out.items() if v}
