"""Host-side cold tier: the full logical table as memmap-backed files —
the counterpart of ``fast_tffm_tpu/paramstore/store.py`` (numpy; the same
files, byte for byte, so each package opens the other's store).

One ``ColdStore`` owns a directory holding the full ``[V, D]`` table and
``[V, A]`` accumulator as row-addressable memmaps (``table.dat``,
``accum.dat``), a one-bit-per-row "written" bitmap (``written.dat``) and
``meta.json``.  Two properties make vocabularies far past the card's memory
(and past host RAM) workable:

  * **sparse files** — the data files are created by ``truncate`` alone,
    so a 2^31-row store costs disk only for the pages of rows actually
    written; host RAM is the page cache's working set, not the table;
  * **lazy row init** — a row never written reads as its deterministic
    init: a counter-based hash expands ``(seed, id, col)`` to the same
    uniform ``[-r, r)`` factor every time (bias column 0 stays 0.0, as in
    every model's ``init_table``).  Small vocabularies can instead be
    created with the exact init draw written in (``init_table``), which is
    what makes a tiered run bitwise the resident run (a generator's bulk
    draw is not reproducible row by row).

Durability (crash-consistency invariant 7): rows reach the store only
through the post-publish apply of a checkpoint boundary whose npz already
carries the same rows, so every store write is redo the chain can replay.
``meta.json`` records the last applied boundary's save_id (tmp + replace);
a store whose ``applied_sig`` names a save the chain no longer holds is
refused at restore, never mixed.
"""

from __future__ import annotations

import json
import os
import uuid

import numpy as np

__all__ = ["ColdStore", "hashed_uniform_rows"]

_META = "meta.json"
_TABLE = "table.dat"
_ACCUM = "accum.dat"
_WRITTEN = "written.dat"

STORE_VERSION = 1


def hashed_uniform_rows(
    ids: np.ndarray, row_dim: int, seed: int, init_range: float
) -> np.ndarray:
    """Deterministic per-row init: uniform [-r, r) factors from a
    counter-based integer hash of (seed, id, col); column 0 (the bias
    slot every model's init_table zeroes) stays 0.0.  Vectorized — a
    2^30-row store never materializes anything; rows are conjured as
    they are first touched."""
    ids = np.asarray(ids, np.uint64).reshape(-1, 1)
    cols = np.arange(row_dim, dtype=np.uint64).reshape(1, -1)
    # splitmix64 over a (seed, id, col) counter — full-width avalanche,
    # so adjacent ids/cols decorrelate.
    seed_mix = np.uint64((int(seed) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF)
    x = (
        ids * np.uint64(0x9E3779B97F4A7C15)
        + cols * np.uint64(0xBF58476D1CE4E5B9)
        + seed_mix
    )
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    u = (x >> np.uint64(40)).astype(np.float32) / np.float32(1 << 24)  # [0, 1)
    rows = ((u * 2.0 - 1.0) * np.float32(init_range)).astype(np.float32)
    rows[:, 0] = 0.0  # bias column
    return rows


class ColdStore:
    """Row-addressable host store for one logical table (+ accumulator).

    All reads/writes take LOGICAL row ids.  Reads overlay nothing — the
    caller (paramstore.tiered) owns the pending-writeback overlay; this
    class is purely the durable bottom tier."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.vocab = int(meta["vocab"])
        self.row_dim = int(meta["row_dim"])
        self.accum_width = int(meta["accum_width"])
        self._table = np.memmap(
            os.path.join(path, _TABLE), np.float32, mode="r+",
            shape=(self.vocab, self.row_dim),
        )
        self._accum = np.memmap(
            os.path.join(path, _ACCUM), np.float32, mode="r+",
            shape=(self.vocab, self.accum_width),
        )
        self._written = np.memmap(
            os.path.join(path, _WRITTEN), np.uint8, mode="r+",
            shape=((self.vocab + 7) // 8,),
        )

    # -- creation / opening ----------------------------------------------

    @classmethod
    def create(
        cls,
        path: str,
        *,
        vocab: int,
        row_dim: int,
        accum_width: int,
        seed: int,
        init_range: float,
        init_accum: float,
        init_table=None,
        init_accum_arr=None,
    ) -> "ColdStore":
        """Fresh store.  ``init_table``/``init_accum_arr`` (host arrays)
        materialize the exact init into the files (small vocabs — the
        bit-identity path); without them, rows stay lazy (sparse files,
        hashed_uniform on first read)."""
        os.makedirs(path, exist_ok=True)
        for name, width in ((_TABLE, row_dim), (_ACCUM, accum_width)):
            with open(os.path.join(path, name), "wb") as f:
                f.truncate(vocab * width * 4)
        with open(os.path.join(path, _WRITTEN), "wb") as f:
            f.truncate((vocab + 7) // 8)
        meta = {
            "version": STORE_VERSION,
            "vocab": int(vocab),
            "row_dim": int(row_dim),
            "accum_width": int(accum_width),
            "seed": int(seed),
            "init_range": float(init_range),
            "init_accum": float(init_accum),
            "materialized": init_table is not None,
            "fingerprint": uuid.uuid4().hex,
            "applied_sig": None,
        }
        cls._write_meta(path, meta)
        store = cls(path, meta)
        if init_table is not None:
            t = np.asarray(init_table, np.float32)
            a = np.asarray(init_accum_arr, np.float32)
            if t.shape != (vocab, row_dim) or a.shape != (vocab, accum_width):
                raise ValueError(
                    f"materialized init shapes {t.shape}/{a.shape} do not "
                    f"match store [{vocab}, {row_dim}]/[{vocab}, {accum_width}]"
                )
            # Chunked copy: bounded dirty pages, no 2x table on heap.
            chunk = max(1, (64 << 20) // max(1, row_dim * 4))
            for lo in range(0, vocab, chunk):
                hi = min(vocab, lo + chunk)
                store._table[lo:hi] = t[lo:hi]
                store._accum[lo:hi] = a[lo:hi]
            store._written[:] = 0xFF
            store.flush()
        return store

    @classmethod
    def open(cls, path: str) -> "ColdStore":
        meta_path = os.path.join(path, _META)
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"parameter store at {path!r} is missing or corrupt "
                f"({e}) — delete the directory to start fresh"
            ) from e
        if int(meta.get("version", 0)) != STORE_VERSION:
            raise ValueError(
                f"parameter store {path!r} has version "
                f"{meta.get('version')}, this build writes {STORE_VERSION}"
            )
        return cls(path, meta)

    @staticmethod
    def _write_meta(path: str, meta: dict) -> None:
        tmp = os.path.join(path, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, _META))

    @property
    def fingerprint(self) -> str:
        return self.meta["fingerprint"]

    @property
    def applied_sig(self) -> str | None:
        return self.meta.get("applied_sig")

    def set_applied(self, sig: str | None) -> None:
        """Record the last checkpoint boundary whose rows were applied
        (atomic publish — the restore-time orphan check reads this)."""
        self.meta["applied_sig"] = sig
        self._write_meta(self.path, self.meta)

    # -- row IO ------------------------------------------------------------

    def _written_mask(self, ids: np.ndarray) -> np.ndarray:
        b = self._written[ids >> 3]
        return (b >> (ids & 7).astype(np.uint8)) & 1 > 0

    def read_rows(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(table_rows [n, D], accum_rows [n, A]) for logical ``ids`` —
        written rows from the files (``_file_rows``), unwritten rows from
        the lazy init."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.vocab):
            raise ValueError(
                f"store read out of range: ids span "
                f"[{ids.min()}, {ids.max()}] for vocab {self.vocab}"
            )
        written = self._written_mask(ids)
        t = np.empty((ids.size, self.row_dim), np.float32)
        a = np.empty((ids.size, self.accum_width), np.float32)
        if written.any():
            t[written], a[written] = self._file_rows(ids[written])
        if not written.all():
            cold = ids[~written]
            t[~written] = hashed_uniform_rows(
                cold, self.row_dim, self.meta["seed"], self.meta["init_range"]
            )
            a[~written] = np.float32(self.meta["init_accum"])
        return t, a

    def _file_rows(self, ids: np.ndarray, rows=None):
        """Read (``rows`` None) or write the table and accumulator rows of
        logical ``ids``.  A materialized store's pages all exist: its rows
        go through the memmaps.  A lazy store's go through ``os.pread`` /
        ``os.pwrite``, one call per run of consecutive ids: a fancy-index
        store through a memmap over a sparse file allocates its pages one
        fault at a time (two orders slower at a 2^31-row store), and a
        network filesystem may cache far more than the faulted pages.
        Neither path serves both stores (``tools/torch_store_io.py``): on a
        materialized store the memmap reads and writes a step's missed rows
        several times faster than preads even with nearby ids merged into
        one read, and on a lazy store's scattered ids merging saves
        nothing.  The page cache is shared, so either path sees the other's
        rows."""
        if self.meta.get("materialized"):
            if rows is None:
                return self._table[ids], self._accum[ids]
            self._table[ids], self._accum[ids] = rows
            return None
        order = np.argsort(ids, kind="stable")
        sid = ids[order]
        breaks = np.flatnonzero(np.diff(sid) != 1) + 1
        runs = list(zip(np.concatenate([[0], breaks]).tolist(),
                        np.concatenate([breaks, [sid.size]]).tolist()))
        out = []
        for k, (name, width) in enumerate(((_TABLE, self.row_dim), (_ACCUM, self.accum_width))):
            flags = os.O_RDONLY if rows is None else os.O_WRONLY
            fd = os.open(os.path.join(self.path, name), flags)
            try:
                if rows is None:
                    got = np.empty((ids.size, width), np.float32)
                    for lo, hi in runs:
                        got[lo:hi] = np.frombuffer(
                            os.pread(fd, (hi - lo) * width * 4, int(sid[lo]) * width * 4),
                            np.float32).reshape(hi - lo, width)
                    back = np.empty_like(got)
                    back[order] = got
                    out.append(back)
                else:
                    data = np.ascontiguousarray(np.asarray(rows[k], np.float32)[order])
                    for lo, hi in runs:
                        os.pwrite(fd, data[lo:hi].tobytes(), int(sid[lo]) * width * 4)
            finally:
                os.close(fd)
        return tuple(out) if rows is None else None

    def write_rows(self, ids: np.ndarray, table_rows, accum_rows) -> None:
        """Rows of logical ``ids`` (unique within one write) into both files
        (``_file_rows``), their written bits set."""
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.vocab):
            raise ValueError(
                f"store write out of range: ids span "
                f"[{ids.min()}, {ids.max()}] for vocab {self.vocab}"
            )
        self._file_rows(ids, (table_rows, accum_rows))
        self._set_written(ids)

    def _set_written(self, ids: np.ndarray) -> None:
        """OR the written bits in, one read-modify-write per bitmap byte (ids
        sharing a byte combine first)."""
        byte, inv = np.unique(ids >> 3, return_inverse=True)
        bits = np.zeros(byte.size, np.uint8)
        np.bitwise_or.at(bits, inv, (1 << (ids & 7)).astype(np.uint8))
        self._written[byte] = self._written[byte] | bits

    def flush(self) -> None:
        if self.meta.get("materialized"):
            self._table.flush()
            self._accum.flush()
        self._written.flush()
        for name in (_TABLE, _ACCUM):
            fd = os.open(os.path.join(self.path, name), os.O_RDONLY)
            try:
                os.fsync(fd)  # the pwritten rows
            finally:
                os.close(fd)

    def close(self) -> None:
        self.flush()
        # memmaps release with the object; explicit del keeps Windows-ish
        # semantics obvious and makes close() idempotent-safe.
        del self._table, self._accum, self._written
