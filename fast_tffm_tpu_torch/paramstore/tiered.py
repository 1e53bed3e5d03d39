"""Two-tier parameter server: device-resident hot rows + the host cold
store — the counterpart of ``fast_tffm_tpu/paramstore/tiered.py``.

The card holds a COMPACT ``[C, D]`` table (C = hot_rows + miss_rows) with
its accumulator; the host holds the full logical table (``store.py``).
Every batch (or K-group) is resolved ahead of its step:

  1. **resolve** (prefetch thread) — split the call's logical ids into
     hits and misses against the residency map (``residency.py``) and remap
     every id to a device slot: a hot id to its rank in ``[0, H)``, each
     unique missed id to a staging slot in ``[H, H + m)``;
  2. **ship** — the remapped batch packs onto the packed wire
     (``data/wire.py``, spec'd at the capacity C, so ids narrow to the
     compact range) and the missed rows' table and accumulator values ride
     the SAME pinned buffer: one host→device copy, unpacked on the card on
     a side stream;
  3. **stage + step** — an in-place ``copy_`` puts the m missed rows into
     ``table[H:H+m]`` and ``accum[H:H+m]`` (in place: a captured K-step
     graph is keyed on the tensors' storage), then the UNCHANGED train
     step runs over the compact table.  Its math is the resident step's on
     the same values (the tail's segment sums follow the stable sort's
     occurrence order, not the slot numbers), so a tiered run is bitwise
     the resident run at a vocabulary both can hold;
  4. **writeback** (before the next stage) — the staged rows come back to
     the host into the PENDING overlay.  Pending rows reach the cold store
     only at checkpoint boundaries, after the boundary's npz (which holds
     the same rows) is published, so every store write is redo the chain
     can replay (crash-consistency invariant 7).

Coherency: resolution runs in the prefetch thread against a versioned
snapshot of pending; when a writeback lands between a payload's resolution
and its step for one of its miss ids, the step re-reads that payload's
rows and stages them again (a counted ``restage``).

Unlike the JAX package, whose jitted programs need one fixed shape, the
port ships and stages only the m rows a call missed, not ``miss_rows``
padded ones; the slots past m are never read by the call's ids.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from fast_tffm_tpu_torch.data.wire import (
    PinnedStager,
    batch_tensors,
    make_unpacker,
    pack_into,
    wire_nbytes,
)
from fast_tffm_tpu_torch.paramstore.residency import ResidencyMap
from fast_tffm_tpu_torch.paramstore.store import ColdStore

__all__ = ["TieredParamServer", "TieredBatch", "TieredConverter"]


class _RemappedParsed(NamedTuple):
    """ParsedBatch shim with remapped (slot) ids, for the wire packer."""

    batch_size: int
    max_nnz: int
    labels: np.ndarray
    nnz: np.ndarray
    ids: np.ndarray
    vals: np.ndarray
    fields: np.ndarray


def _remap(parsed, local_ids: np.ndarray) -> _RemappedParsed:
    return _RemappedParsed(
        batch_size=parsed.batch_size,
        max_nnz=parsed.max_nnz,
        labels=parsed.labels,
        nnz=parsed.nnz,
        ids=local_ids,
        vals=parsed.vals,
        fields=parsed.fields,
    )


class TieredBatch(NamedTuple):
    """One resolved payload: the remapped device batch, the staged miss
    rows and the host bookkeeping of the step and the delta saves.  ``.ids``
    mirrors Batch, so the touched-row marker works unchanged."""

    batch: object  # device Batch (slot ids), [K, B, ...] or [B, ...]
    miss_t: torch.Tensor  # [m, D] missed table rows (device)
    miss_a: torch.Tensor  # [m, A] their accumulator rows (device)
    miss_ids: np.ndarray  # [m] unique missed LOGICAL ids (host, sorted)
    version: int  # the pending-overlay version the rows were read at

    @property
    def ids(self):
        return self.batch.ids


@functools.lru_cache(maxsize=None)
def _make_tiered_unpacker(spec, row_dim: int, accum_width: int):
    """``unpack(buf, k, m) -> (Batch, miss_t, miss_a)`` of ONE combined
    uint8 buffer ``[K*L wire][m*D f32][m*A f32]`` on its device: the wire
    section through ``make_unpacker`` (``k`` > 0: a ``[K, L]`` group, 0: one
    batch), the rows by bitcast."""
    inner = make_unpacker(spec)

    def unpack(buf: torch.Tensor, k: int, m: int):
        mt_bytes, ma_bytes = m * row_dim * 4, m * accum_width * 4
        batch_bytes = buf.shape[0] - mt_bytes - ma_bytes
        bsec = buf[:batch_bytes]
        b = inner(bsec.view(k, batch_bytes // k) if k > 0 else bsec)
        mt = buf[batch_bytes : batch_bytes + mt_bytes].clone().view(torch.float32)
        ma = buf[batch_bytes + mt_bytes :].clone().view(torch.float32)
        return b, mt.view(m, row_dim), ma.view(m, accum_width)

    return unpack


class _TierStats:
    """Per-run tiering counters, drained into ``kind=tiering`` records at
    every log point (and totals onto kind=summary)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reset()
        self.total_miss_rows = 0
        self.total_writeback_rows = 0
        self.total_restages = 0

    def _reset(self):
        self.steps = 0
        self.hit_slots = 0
        self.total_slots = 0
        self.unique_ids = 0
        self.miss_rows = 0
        self.miss_bytes = 0
        self.wire_bytes = 0
        self.resolve_s = 0.0
        self.writeback_rows = 0
        self.writeback_bytes = 0
        self.writeback_s = 0.0
        self.restages = 0
        self.apply_rows = 0
        self.apply_s = 0.0

    def note_resolve(self, res, wire_bytes, miss_bytes, seconds, steps):
        with self._lock:
            self.steps += steps
            self.hit_slots += res.hit_slots
            self.total_slots += res.total_slots
            self.unique_ids += res.unique_ids
            self.miss_rows += int(res.miss_ids.size)
            self.miss_bytes += miss_bytes
            self.wire_bytes += wire_bytes
            self.resolve_s += seconds
            self.total_miss_rows += int(res.miss_ids.size)

    def note_writeback(self, rows, nbytes, seconds):
        with self._lock:
            self.writeback_rows += rows
            self.writeback_bytes += nbytes
            self.writeback_s += seconds
            self.total_writeback_rows += rows

    def note_restage(self):
        with self._lock:
            self.restages += 1
            self.total_restages += 1

    def note_apply(self, rows, seconds):
        with self._lock:
            self.apply_rows += rows
            self.apply_s += seconds

    def drain(self, pending_rows: int, hot_rows: int) -> dict:
        with self._lock:
            if not self.steps:
                return {}
            out = {
                "hit_rate": round(self.hit_slots / max(1, self.total_slots), 4),
                "miss_rows": self.miss_rows,
                "miss_rows_per_step": round(self.miss_rows / self.steps, 1),
                "miss_bytes_per_step": int(self.miss_bytes / self.steps),
                "wire_bytes_per_step": int(self.wire_bytes / self.steps),
                "dedup_ratio": round(self.unique_ids / max(1, self.total_slots), 4),
                "writeback_rows": self.writeback_rows,
                "writeback_ms": round(1e3 * self.writeback_s, 3),
                "resolve_ms": round(1e3 * self.resolve_s, 3),
                "restages": self.restages,
                "pending_rows": pending_rows,
                "hot_rows": hot_rows,
                "apply_rows": self.apply_rows,
                "apply_ms": round(1e3 * self.apply_s, 3),
            }
            self._reset()
        return out


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (never a view of a CPU state's live tensor,
    which the next stage overwrites)."""
    return t.to("cpu", copy=True).numpy()


def _rows_tensor(rows: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)


class TieredParamServer:
    """One run's residency map, cold store, pending overlay and the device
    stage/fetch steps (see the module docstring)."""

    def __init__(self, store: ColdStore, hot_ids: np.ndarray, miss_rows: int, model, *,
                 init_accum: float):
        self.store = store
        self.residency = ResidencyMap(hot_ids)
        self.hot_rows = self.residency.hot_rows
        self.miss_rows = max(1, int(miss_rows))
        self.capacity = self.hot_rows + self.miss_rows
        self.model = model
        self.row_dim = int(model.row_dim)
        self.accum_width = store.accum_width
        self.init_accum = float(init_accum)
        self.stats = _TierStats()
        # Pending writeback overlay: sorted logical ids with their table and
        # accumulator rows (the JAX package keeps a dict of rows; sorted
        # arrays give the same lookups in numpy, without a Python loop over
        # a call's ~10^5 missed rows), versioned so a resolution made ahead
        # can be checked for staleness at its step; _recent keeps the last
        # writeback id sets for that check (an older payload restages
        # conservatively).
        self._p_ids = np.zeros((0,), np.int64)
        self._p_t = np.zeros((0, self.row_dim), np.float32)
        self._p_a = np.zeros((0, self.accum_width), np.float32)
        self._version = 0
        self._recent: deque = deque(maxlen=64)
        self._lock = threading.Lock()
        self._last_staged: np.ndarray | None = None
        self._applies = 0

    # -- device steps -------------------------------------------------------

    @torch.no_grad()
    def _stage(self, state, mt: torch.Tensor, ma: torch.Tensor) -> None:
        """The missed rows into the staging slots, in place."""
        h, m = self.hot_rows, mt.shape[0]
        if m:
            state.table[h : h + m].copy_(mt)
            state.table_accum[h : h + m].copy_(ma)

    def _fetch(self, state, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The first ``n`` staging rows, device→host (waits for the step)."""
        h = self.hot_rows
        return _host_copy(state.table[h : h + n]), _host_copy(state.table_accum[h : h + n])

    # -- pending overlay ----------------------------------------------------

    def read_latest(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
        """(table rows, accum rows, version) for logical ``ids``: the pending
        overlay over the cold store.  Thread-safe (the prefetch thread reads
        here, and the loop thread on a restage)."""
        ids = np.asarray(ids, np.int64)
        with self._lock:
            version = self._version
            pos, hit = _find(self._p_ids, ids)
            hit_t, hit_a = self._p_t[pos[hit]], self._p_a[pos[hit]]  # copies
        t = np.empty((ids.size, self.row_dim), np.float32)
        a = np.empty((ids.size, self.accum_width), np.float32)
        if not hit.all():
            # Only the rows the overlay does not cover touch the store.
            t[~hit], a[~hit] = self.store.read_rows(ids[~hit])
        t[hit], a[hit] = hit_t, hit_a
        return t, a, version

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return int(self._p_ids.size)

    def flush_writeback(self, state) -> None:
        """The previous call's staged rows, device→host, into the pending
        overlay.  Called before every stage (the slots are about to be
        reused) and at every checkpoint boundary (pending must name the
        latest value of every non-resident touched row)."""
        ids = self._last_staged
        if ids is None or ids.size == 0:
            self._last_staged = None
            return
        t0 = time.perf_counter()
        n = int(ids.size)
        mt, ma = self._fetch(state, n)
        ids = np.asarray(ids, np.int64)  # sorted and unique (a resolution's miss_ids)
        with self._lock:
            self._version += 1
            pos, old = _find(self._p_ids, ids)
            self._p_t[pos[old]], self._p_a[pos[old]] = mt[old], ma[old]
            new = ~old
            if new.any():
                at = pos[new]
                self._p_ids = np.insert(self._p_ids, at, ids[new])
                self._p_t = np.insert(self._p_t, at, mt[new], axis=0)
                self._p_a = np.insert(self._p_a, at, ma[new], axis=0)
            self._recent.append((self._version, ids))
        self._last_staged = None
        self.stats.note_writeback(n, n * 4 * (self.row_dim + self.accum_width),
                                  time.perf_counter() - t0)

    def _stale(self, tb: TieredBatch) -> bool:
        if tb.miss_ids.size == 0:
            return False
        with self._lock:
            if tb.version == self._version:
                return False
            oldest = self._recent[0][0] if self._recent else self._version
            if tb.version < oldest - 1:
                return True  # too old to check precisely: restage
            newer = [ids for v, ids in self._recent if v > tb.version]
        for ids in newer:
            if np.intersect1d(tb.miss_ids, ids, assume_unique=True).size:
                return True
        return False

    # -- step wrapping ------------------------------------------------------

    def wrap_step(self, inner_step):
        """The residency-aware step: flush the previous writeback, stage this
        payload's missed rows (read again on a coherency miss), run the
        UNCHANGED inner step on the remapped batch."""

        def step(state, tb: TieredBatch):
            self.flush_writeback(state)
            mt, ma = tb.miss_t, tb.miss_a
            if self._stale(tb):
                self.stats.note_restage()
                t, a, _ = self.read_latest(tb.miss_ids)
                mt, ma = _rows_tensor(t, mt.device), _rows_tensor(a, ma.device)
            self._stage(state, mt, ma)
            state, loss = inner_step(state, tb.batch)
            self._last_staged = tb.miss_ids
            return state, loss

        step.graphs = getattr(inner_step, "graphs", None)
        return step

    @torch.inference_mode()
    def predict(self, state, parsed, w) -> torch.Tensor:
        """Residency-aware scores for validation: resolve (read-only), hot
        rows from the live state, missed rows from a side tensor; the state
        is not touched.  Call ``flush_writeback(state)`` once before a
        pass."""
        from fast_tffm_tpu_torch.models.base import Batch

        device = state.table.device
        res = self.residency.resolve([parsed.ids], self.miss_rows)
        t, _a, _v = self.read_latest(res.miss_ids)
        # At least one row: an all-hit batch's clamped miss gather reads row 0.
        mt = _rows_tensor(t if t.shape[0] else np.zeros((1, self.row_dim), np.float32), device)
        b = Batch.from_parsed(_remap(parsed, res.remapped[0]), w, device,
                              with_fields=self.model.uses_fields)
        h, m = self.hot_rows, mt.shape[0]
        ids = b.ids.long()
        hot_g = state.table[torch.clamp(ids, max=max(0, h - 1))]
        miss_g = mt[torch.clamp(ids - h, 0, m - 1)]
        rows = torch.where((ids < h)[..., None], hot_g, miss_g)
        return torch.sigmoid(self.model.score(rows, state.dense, b))

    # -- checkpoint integration (checkpoint_async.AsyncCheckpointer) --------

    def hot_logical_ids(self, slots: np.ndarray) -> np.ndarray:
        """Device slots (< hot_rows) → logical ids."""
        return self.residency.hot_ids[np.asarray(slots, np.int64)]

    def pending_snapshot(self):
        """(ids [n], table rows [n, D], accum rows [n, A]) of the pending
        overlay, sorted by id: the cold half of every boundary save."""
        with self._lock:
            return self._p_ids.copy(), self._p_t.copy(), self._p_a.copy()

    def apply_pending(self, save_id: str) -> None:
        """Post-publish apply: the pending overlay into the cold store (redo
        the chain can replay), then the boundary stamped.  The fault hook
        (``kill_writeback``) fires after the first chunk: a kill there must
        leave the chain loadable with no lost or stale rows."""
        from fast_tffm_tpu_torch.resilience import maybe_writeback_fault

        t0 = time.perf_counter()
        ids, t, a = self.pending_snapshot()
        self._applies += 1
        n = int(ids.size)
        chunk = max(1, (16 << 20) // max(1, self.row_dim * 4))
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            self.store.write_rows(ids[lo:hi], t[lo:hi], a[lo:hi])
            if lo == 0:
                # The kill-during-writeback window: some store pages dirty,
                # the boundary not stamped yet.
                maybe_writeback_fault(self._applies)
        if n == 0:
            maybe_writeback_fault(self._applies)
        self.store.flush()
        self.store.set_applied(save_id)
        with self._lock:
            pos, found = _find(self._p_ids, ids)
            keep = np.ones(self._p_ids.size, bool)
            keep[pos[found]] = False
            self._p_ids, self._p_t, self._p_a = (
                self._p_ids[keep], self._p_t[keep], self._p_a[keep])
        self.stats.note_apply(n, time.perf_counter() - t0)

    def hot_rows_host(self, state) -> tuple[np.ndarray, np.ndarray]:
        """(hot table [H, D], hot accum [H, A]) device→host: the hot half of
        a full boundary save."""
        h = self.hot_rows
        return _host_copy(state.table[:h]), _host_copy(state.table_accum[:h])

    def summary(self) -> dict:
        s = self.stats
        out = {
            "tier_miss_rows": s.total_miss_rows,
            "tier_writeback_rows": s.total_writeback_rows,
            "tier_restages": s.total_restages,
            "tier_pending_rows": self.pending_rows,
        }
        return {k: v for k, v in out.items() if v}


def _find(sorted_ids: np.ndarray, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(position, found) of each of ``ids`` in ``sorted_ids``: where it is,
    or where it would be inserted."""
    pos = np.searchsorted(sorted_ids, ids)
    n = sorted_ids.size
    found = (pos < n) & (sorted_ids[np.minimum(pos, max(0, n - 1))] == ids) if n else (
        np.zeros(ids.shape, bool))
    return pos, found


class TieredConverter:
    """The prefetch thread's resolver and shipper: remap the call's ids,
    read its missed rows through the pending overlay, pack the remapped
    batch (or K-list) on the packed wire WITH those rows into one pinned
    buffer, one host→device copy, the unpack on the card (side stream);
    returns a ``Staged`` TieredBatch.  ``last_nbytes`` / ``calls`` as the
    WireConverter's, for the kind=input records."""

    def __init__(self, server: TieredParamServer, spec, device, *, slots: int = 2):
        self.server = server
        self.spec = spec
        self._unpack = _make_tiered_unpacker(spec, server.row_dim, server.accum_width)
        self._stager = PinnedStager(device, slots)
        self.uses_fields = server.model.uses_fields
        self.last_nbytes = 0
        self.calls = 0

    def __call__(self, parsed, w):
        t0 = time.perf_counter()
        srv = self.server
        seq = parsed if isinstance(parsed, list) else [parsed]
        res = srv.residency.resolve([p.ids for p in seq], srv.miss_rows)
        t, a, version = srv.read_latest(res.miss_ids)
        remapped = [_remap(p, r) for p, r in zip(seq, res.remapped)]
        wire = wire_nbytes(self.spec, seq)
        m = int(res.miss_ids.size)
        nbytes = wire + t.nbytes + a.nbytes
        buf = self._stager.buffer(nbytes)
        pack_into(self.spec, buf[:wire], remapped if isinstance(parsed, list) else remapped[0],
                  w, verify_ids=False)
        buf[wire : wire + t.nbytes] = t.view(np.uint8).reshape(-1)
        buf[wire + t.nbytes :] = a.view(np.uint8).reshape(-1)
        dev = self._stager.ship()
        with self._stager.side():
            b, mt, ma = self._unpack(dev, len(seq) if isinstance(parsed, list) else 0, m)
        self.last_nbytes = nbytes
        self.calls += 1
        srv.stats.note_resolve(res, nbytes, t.nbytes + a.nbytes, time.perf_counter() - t0,
                               len(seq))
        tb = TieredBatch(batch=b, miss_t=mt, miss_a=ma, miss_ids=res.miss_ids, version=version)
        return self._stager.staged(tb, (*batch_tensors(b), mt, ma))
