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

Every save emits a ``kind=ckpt`` record (``mode`` full / delta / sync, its
snapshot, convert, D2H and write times, bytes, rows and the train loop's
stall) through the RunMonitor.  The JAX module's tiered-store and
multi-process single-writer paths are later slices of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import uuid

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
    ):
        self._path = path
        self._device = torch.device(device)
        self._monitor = monitor
        self._log = log
        self._chunk = int(chunk_bytes)
        self._async = bool(async_save)
        self._delta_every = int(delta_every_steps)
        self._chain_max = max(1, int(delta_chain_max))
        self._full_every_s = float(full_every_s)
        self._chain_bytes_max = int(chain_max_bytes)
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
        self._side = torch.cuda.Stream(self._device) if cuda else None
        self._staging = (torch.empty(self._chunk, dtype=torch.uint8, pin_memory=True)
                         if cuda else None)
        self._bitmap = None
        self._row_dim = int(row_dim)
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

    def note_batch(self, ids) -> None:
        """OR one call's logical ids (a tensor on the run's device) into the
        touched bitmap (delta mode only)."""
        if self._delta_every <= 0:
            return
        if self._bitmap is None:
            self._bitmap = self._fresh_bitmap()
        self._bitmap.index_fill_(0, ids.reshape(-1).long(), True)

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

    # -- boundaries -------------------------------------------------------

    def save_boundary(self, state, saveable, step: int, *, sync: bool = False,
                      emit: bool = True) -> None:
        """Full save: async (snapshot + writer thread) unless ``sync`` or
        ``async_save`` is off."""
        t0 = time.perf_counter()
        self._drain(count=True)
        if self._delta_every > 0:
            # A full save supersedes the accumulated window either way.
            self._bitmap = self._fresh_bitmap() if self._bitmap is not None else None
            self._last_boundary_step = int(step)
        cursor = self._cursor()
        sid = uuid.uuid4().hex
        if sync or not self._async:
            logical = saveable(state)
            t1 = time.perf_counter()
            timings: dict = {}
            try:
                nbytes = save_checkpoint(self._path, logical, chunk_bytes=self._chunk,
                                         save_id=sid, cursor=cursor, timings=timings,
                                         staging=self._staging)
            except Exception:
                with self._lock:
                    self.write_failures += 1
                raise  # a synchronous save failing must surface: it is the last line
            self._on_full_published(sid)
            self.sync_saves += 1
            if emit:
                self._emit("sync", step, timings, nbytes=nbytes, rows=logical.table.shape[0],
                           snapshot_ms=0.0, convert_ms=(t1 - t0) * 1e3,
                           train_stall_ms=(time.perf_counter() - t0) * 1e3)
            return
        snap, ready = device_snapshot(state)
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._spawn(self._write_full, (snap, ready, saveable, int(step), sid, stall_ms, emit,
                                       cursor))

    def delta_boundary(self, state, saveable, step: int) -> None:
        """Delta save of the touched window; promotes itself to a full save
        when there is no signed base yet or the chain is long, old or fat."""
        t0 = time.perf_counter()
        self._drain(count=True)
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
        if self._bitmap is not None:
            idx_dev = torch.nonzero(self._bitmap).reshape(-1)  # sorted, one sync
        else:
            idx_dev = torch.zeros(0, dtype=torch.int64, device=self._device)
        self._bitmap = self._fresh_bitmap()
        self._last_boundary_step = int(step)
        trows, arows = gather_rows(state, idx_dev, self._row_dim)
        dense = [p.clone() for p in state.dense]
        dacc = [a.clone() for a in state.dense_accum]
        ready = _record(self._device)
        idx = idx_dev.cpu().numpy()
        with self._lock:
            seq, parent = self._next_seq, self._parent_sig
        cursor = self._cursor()
        stall_ms = (time.perf_counter() - t0) * 1e3
        self._spawn(self._write_delta, (seq, parent, idx, trows, arows, dense, dacc, ready,
                                        int(state.step), int(step), stall_ms, cursor))

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
        land after (and clobber) the final synchronous one."""
        self._drain()

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

    def _write_full(self, snap, ready, saveable, step, sid, stall_ms, emit, cursor) -> None:
        try:
            with self._on_writer_stream(ready):
                t0 = time.perf_counter()
                logical = saveable(snap)
                self._sync_writer_stream()
                convert_ms = (time.perf_counter() - t0) * 1e3
                timings: dict = {}
                nbytes = save_checkpoint(self._path, logical, chunk_bytes=self._chunk,
                                         save_id=sid, cursor=cursor, timings=timings,
                                         staging=self._staging)
            self._on_full_published(sid)
            with self._lock:
                self.full_saves += 1
            if emit:
                self._emit("full", step, timings, nbytes=nbytes, rows=logical.table.shape[0],
                           snapshot_ms=stall_ms, convert_ms=convert_ms,
                           train_stall_ms=stall_ms)
        # analysis: ok exception-hygiene the writer thread's boundary: counted, logged, the previous checkpoint stays the last good state
        except Exception as e:
            self._on_write_failed()
            log_quietly(self._log,
                        f"async checkpoint write failed (previous checkpoint intact): {e!r}")

    def _write_delta(self, seq, parent, idx, trows, arows, dense, dacc, ready, state_step,
                     step, stall_ms, cursor) -> None:
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
            self._emit("delta", step, timings, nbytes=nbytes, rows=int(idx.size),
                       snapshot_ms=stall_ms, convert_ms=convert_ms, train_stall_ms=stall_ms)
        # analysis: ok exception-hygiene the writer thread's boundary: counted, logged, the chain stays intact and the next boundary promotes to full
        except Exception as e:
            self._on_write_failed()
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
