"""The FMS append-only stream container and the reader that follows it — the
counterpart of ``fast_tffm_tpu/data/stream.py`` (numpy only), byte for byte
the JAX package's format.

Online learning (``[Online] follow = true``) trains on events as they
arrive.  FMB cannot take appends (its columnar sections are sized at write
time), so FMS is row-major: one 64-byte header, then fixed-size records
appended for ever::

    header  64 B   magic 'FMS1', version, width, vocabulary_size, hashed
    record         label f32 | nnz i32 | ids i32[W] | vals f32[W]
                   | fields i32[W]          (8 + 12·W bytes, little-endian)

The row count is derived from the file size, so a reader never needs a
header rewrite to see new rows; a partial trailing record (a writer
crash, or an append caught mid-write) does not count and is looked at
again on the next poll: the reader waits it out and never parses half a
record.

``fms_follow_stream`` follows the file: at EOF it polls the size at a
bounded interval instead of ending the epoch, marks itself idle (the stall
watchdog then classifies a starved loop as input-starved (stream-idle)),
and goes on when bytes land.  It emits full batches only, so batch k is
rows [k·B, (k+1)·B) and the resume cursor's batch count maps to a byte
offset by multiplication; rows short of a batch stay in the file for the
next poll or the next process.

A followed file's identity for resume is its prefix (the header and the
first 64 KiB of records, immutable under appends): a resume against a
file whose prefix changed (replaced, truncated, rewritten) fails loudly.
"""

from __future__ import annotations

import hashlib
import os
import struct
import time
from collections.abc import Sequence

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import ParsedBatch

__all__ = [
    "FMS_MAGIC",
    "FMS_VERSION",
    "FMS_HEADER_BYTES",
    "is_fms",
    "fms_record_bytes",
    "read_fms_header",
    "fms_row_count",
    "StreamWriter",
    "read_fms_rows",
    "fms_follow_stream",
    "stream_prefix_fingerprint",
    "stream_prefix_matches",
]

FMS_MAGIC = b"FMS1"
FMS_VERSION = 1
FMS_HEADER_BYTES = 64
# magic, version, width, vocabulary_size, hashed, flags (reserved 0)
_HEADER = struct.Struct("<4sIqqBB")
assert _HEADER.size <= FMS_HEADER_BYTES
_PREFIX_HASH_BYTES = 64 << 10  # the identity window, immutable under appends


def fms_record_bytes(width: int) -> int:
    """label f32 + nnz i32 + (ids + vals + fields) i32/f32[width]."""
    return 8 + 12 * int(width)


def is_fms(path) -> bool:
    """True when ``path`` starts with the FMS magic (a missing file: False)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == FMS_MAGIC
    except OSError:
        return False


def read_fms_header(path) -> dict:
    with open(path, "rb") as f:
        raw = f.read(FMS_HEADER_BYTES)
    if len(raw) < FMS_HEADER_BYTES:
        raise ValueError(f"{path}: truncated FMS header")
    magic, version, width, vocab, hashed, _flags = _HEADER.unpack(raw[: _HEADER.size])
    if magic != FMS_MAGIC:
        raise ValueError(f"{path}: not an FMS stream file")
    if version != FMS_VERSION:
        raise ValueError(f"{path}: unsupported FMS version {version}")
    if width < 1:
        raise ValueError(f"{path}: bad FMS width {width}")
    return {
        "path": os.fspath(path),
        "width": int(width),
        "vocabulary_size": int(vocab),
        "hashed": bool(hashed),
        "record_bytes": fms_record_bytes(width),
    }


def fms_row_count(path, width: int) -> int:
    """The complete records in the file now; a partial trailing record does
    not count (floor division is the wait)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return 0
    return max(0, (size - FMS_HEADER_BYTES)) // fms_record_bytes(width)


class StreamWriter:
    """The append side of the FMS format.  Creates the file with its header
    if it is absent; ``append`` writes whole records and flushes, so a
    reader polling the size sees complete rows only — except through
    ``append_torn``, the fault hook that leaves a partial trailing record
    on disk (flushed) until ``complete_torn`` lands the rest: the window the
    follow reader must wait out."""

    def __init__(self, path, *, width: int, vocabulary_size: int,
                 hash_feature_id: bool = False):
        self.path = os.fspath(path)
        self.width = int(width)
        self.vocabulary_size = int(vocabulary_size)
        self.record_bytes = fms_record_bytes(self.width)
        self.appends = 0  # the append ordinal (append_torn@K counts it)
        self._torn_rest: bytes | None = None
        if os.path.exists(self.path):
            hdr = read_fms_header(self.path)
            if hdr["width"] != self.width or hdr["vocabulary_size"] != self.vocabulary_size:
                raise ValueError(
                    f"{self.path}: existing stream has width={hdr['width']} "
                    f"vocab={hdr['vocabulary_size']}, writer wants "
                    f"{self.width}/{self.vocabulary_size}"
                )
            self._f = open(self.path, "ab")
        else:
            self._f = open(self.path, "wb")
            hdr = _HEADER.pack(FMS_MAGIC, FMS_VERSION, self.width, self.vocabulary_size,
                               1 if hash_feature_id else 0, 0)
            self._f.write(hdr + b"\0" * (FMS_HEADER_BYTES - len(hdr)))
            self._f.flush()

    def _encode(self, labels, ids, vals, fields, nnz) -> bytes:
        n = len(labels)
        w = self.width
        rec = np.zeros((n, self.record_bytes), np.uint8)
        rec[:, 0:4] = np.asarray(labels, "<f4").reshape(n, 1).view(np.uint8)
        nnz = np.asarray(nnz, "<i4")
        if nnz.size and (int(nnz.max()) > w or int(nnz.min()) < 0):
            raise ValueError(f"stream append: nnz out of [0, {w}] (got max {int(nnz.max())})")
        id_arr = np.asarray(ids)
        if id_arr.size and (int(id_arr.max()) >= self.vocabulary_size or int(id_arr.min()) < 0):
            # The text parsers' range rule: an out-of-range id would train
            # the wrong row downstream.
            raise ValueError(
                f"stream append: id out of [0, {self.vocabulary_size}) "
                f"(got max {int(id_arr.max())}, min {int(id_arr.min())})"
            )
        rec[:, 4:8] = nnz.reshape(n, 1).view(np.uint8)

        def put(col, arr, dtype):
            a = np.zeros((n, w), dtype)
            src = np.asarray(arr, dtype)
            cw = min(w, src.shape[1]) if src.ndim == 2 else 0
            if cw:
                a[:, :cw] = src[:, :cw]
            rec[:, col : col + 4 * w] = a.view(np.uint8).reshape(n, 4 * w)

        put(8, ids, "<i4")
        put(8 + 4 * w, vals, "<f4")
        put(8 + 8 * w, fields if fields is not None else np.zeros((n, w)), "<i4")
        return rec.tobytes()

    def append(self, labels, ids, vals, fields=None, nnz=None) -> int:
        """Append ``n`` whole rows; returns the append ordinal (1-based).  A
        pending torn record is completed first (appending into the middle
        of a partial record would misalign every later one)."""
        self.complete_torn()
        if nnz is None:
            nnz = (np.asarray(vals) != 0).sum(axis=1)
        self._f.write(self._encode(labels, ids, vals, fields, nnz))
        self._f.flush()
        self.appends += 1
        return self.appends

    def append_torn(self, labels, ids, vals, fields=None, nnz=None) -> int:
        """The ``append_torn@K`` fault: write the rows but only the first
        half of the last record's bytes, and flush; ``complete_torn`` lands
        the rest.  A previous pending torn record is completed first."""
        self.complete_torn()
        if nnz is None:
            nnz = (np.asarray(vals) != 0).sum(axis=1)
        blob = self._encode(labels, ids, vals, fields, nnz)
        cut = len(blob) - self.record_bytes // 2
        self._f.write(blob[:cut])
        self._f.flush()
        self._torn_rest = blob[cut:]
        self.appends += 1
        return self.appends

    def complete_torn(self) -> None:
        if self._torn_rest is not None:
            self._f.write(self._torn_rest)
            self._f.flush()
            self._torn_rest = None

    def close(self) -> None:
        self.complete_torn()
        try:
            self._f.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fms_rows(path, start: int, count: int, *, header: dict | None = None):
    """Decode ``count`` complete records from row ``start`` into (labels,
    nnz, ids, vals, fields) host arrays: a positional read; the caller keeps
    ``start + count`` within ``fms_row_count``."""
    hdr = header or read_fms_header(path)
    w, rb = hdr["width"], hdr["record_bytes"]
    with open(path, "rb") as f:
        f.seek(FMS_HEADER_BYTES + start * rb)
        raw = f.read(count * rb)
    if len(raw) < count * rb:
        raise ValueError(
            f"{path}: short read at row {start} (+{count}) — writer "
            "truncated an append-only stream?"
        )
    rec = np.frombuffer(raw, np.uint8).reshape(count, rb)
    labels = rec[:, 0:4].copy().view("<f4").reshape(count)
    nnz = rec[:, 4:8].copy().view("<i4").reshape(count)
    ids = rec[:, 8 : 8 + 4 * w].copy().view("<i4").reshape(count, w)
    vals = rec[:, 8 + 4 * w : 8 + 8 * w].copy().view("<f4").reshape(count, w)
    fields = rec[:, 8 + 8 * w : 8 + 12 * w].copy().view("<i4").reshape(count, w)
    if count and (int(nnz.max()) > w or int(nnz.min()) < 0):
        # A complete record with an impossible nnz is corruption, not a
        # torn tail (floor division excluded partial records).
        bad = int(np.argmax((nnz > w) | (nnz < 0)))
        raise ValueError(
            f"{path}: corrupt stream record at row {start + bad} "
            f"(nnz {int(nnz[bad])} outside [0, {w}])"
        )
    vocab = hdr["vocabulary_size"]
    if count and (int(ids.max()) >= vocab or int(ids.min()) < 0):
        bad = int(np.argmax(((ids >= vocab) | (ids < 0)).any(axis=1)))
        raise ValueError(
            f"{path}: corrupt stream record at row {start + bad} "
            f"(feature id outside [0, {vocab}))"
        )
    return labels, nnz, ids, vals, fields


def stream_prefix_fingerprint(files: Sequence[str]) -> str:
    """The follow cursor's input identity, stable under appends: per file
    ``<bytes hashed>:<md5 of them>`` over the header and the first (up to
    64 KiB of) record bytes at fingerprint time.  The hashed length rides
    along, so a later check re-hashes the same window
    (``stream_prefix_matches``)."""
    parts = []
    for p in files:
        try:
            with open(os.fspath(p), "rb") as f:
                blob = f.read(FMS_HEADER_BYTES + _PREFIX_HASH_BYTES)
        except OSError:
            blob = b""
        parts.append(f"{len(blob)}:{hashlib.md5(blob).hexdigest()[:16]}")
    return "fms1," + ",".join(parts)


def stream_prefix_matches(files: Sequence[str], fingerprint: str) -> bool:
    """Check a ``stream_prefix_fingerprint`` against the files now: False
    for a foreign fingerprint, another file count, a file now shorter than
    the recorded window (truncated) or any hash mismatch."""
    if not isinstance(fingerprint, str) or not fingerprint.startswith("fms1,"):
        return False
    entries = fingerprint[len("fms1,") :].split(",")
    if len(entries) != len(files):
        return False
    for p, ent in zip(files, entries):
        n_s, sep, want = ent.partition(":")
        if not sep:
            return False
        try:
            n = int(n_s)
        except ValueError:
            return False
        try:
            with open(os.fspath(p), "rb") as f:
                blob = f.read(n)
        except OSError:
            return False
        if len(blob) != n or hashlib.md5(blob).hexdigest()[:16] != want:
            return False
    return True


def fms_follow_stream(
    path,
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    poll_s: float = 0.2,
    idle_timeout_s: float = 0.0,
    max_batches: int = 0,
    skip_batches: int = 0,
    weight: float = 1.0,
    stop=None,
    idle_flag=None,
):
    """Follow ``path``, yielding ``(ParsedBatch, weights)`` full batches
    until a bound ends the stream:

    * only full batches: batch k is rows [k·B, (k+1)·B); rows short of a
      batch stay in the file;
    * at EOF the reader polls the size every ``poll_s`` seconds;
      ``idle_flag`` (any object with ``set`` and ``clear``) tracks the idle
      state for the stall watchdog;
    * a partial trailing record never parses;
    * the file's identity is checked as it goes: the prefix fingerprint
      taken at open is re-hashed on every turn into idle and every 512
      batches, and a size below the consumed offset fails at once — a
      stream replaced, rewritten or truncated mid-run raises;
    * ``skip_batches`` opens at that batch (the resume seek, one file seek);
    * ``max_batches`` > 0 ends the stream once the batch index, skipped
      batches included, reaches it; ``idle_timeout_s`` > 0 ends it after
      that much continuous idleness; ``stop`` (anything with ``is_set``)
      ends it at the next poll.  0 / None: follow until told to stop.
    """
    hdr = read_fms_header(path)
    if hdr["hashed"] != bool(hash_feature_id):
        raise ValueError(
            f"{path}: stream written with hash_feature_id={hdr['hashed']}, "
            f"requested {bool(hash_feature_id)}"
        )
    if hdr["hashed"] and hdr["vocabulary_size"] != vocabulary_size:
        raise ValueError(
            f"{path}: stream hashed into vocabulary_size="
            f"{hdr['vocabulary_size']}, requested {vocabulary_size}"
        )
    if not hdr["hashed"] and hdr["vocabulary_size"] > vocabulary_size:
        raise ValueError(
            f"{path}: stream ids validated against vocabulary_size="
            f"{hdr['vocabulary_size']} > requested {vocabulary_size}"
        )
    fw = hdr["width"]
    width = int(max_nnz) if max_nnz else fw
    cw = min(fw, width)
    if skip_batches < 0:
        raise ValueError(f"skip_batches must be >= 0, got {skip_batches}")
    poll_s = max(0.01, float(poll_s))
    fingerprint = stream_prefix_fingerprint([path])

    def check_identity():
        if not stream_prefix_matches([path], fingerprint):
            raise ValueError(
                f"{path}: stream PREFIX changed while following (file "
                "replaced/rewritten mid-run?) — the current byte offset "
                "no longer names the data it was advanced over"
            )

    emitted = skip_batches  # skipped batches count toward max_batches
    pos = skip_batches * batch_size
    idle_since = None
    since_check = 0
    while True:
        if max_batches and emitted >= max_batches:
            return
        avail = fms_row_count(path, fw)
        if avail < pos:
            raise ValueError(
                f"{path}: stream shrank below the consumed offset "
                f"({avail} rows < position {pos}) — truncated/replaced "
                "mid-run; append-only streams never shrink"
            )
        if avail - pos >= batch_size:
            if stop is not None and stop.is_set():
                # An abandoned stream with a backlog stops producing too.
                return
            since_check += 1
            if since_check >= 512:
                # A same-or-larger replacement never reaches the EOF path.
                since_check = 0
                check_identity()
            if idle_flag is not None and idle_since is not None:
                idle_flag.clear()
            idle_since = None
            labels, nnz, ids, vals, fields = read_fms_rows(path, pos, batch_size, header=hdr)
            if cw < fw and int(nnz.max(initial=0)) > cw:
                raise ValueError(
                    f"{path}: stream rows up to {int(nnz.max())} features > max_nnz={width}"
                )
            out_ids = np.zeros((batch_size, width), np.int32)
            out_vals = np.zeros((batch_size, width), np.float32)
            out_flds = np.zeros((batch_size, width), np.int32)
            out_ids[:, :cw] = ids[:, :cw]
            out_vals[:, :cw] = vals[:, :cw]
            out_flds[:, :cw] = fields[:, :cw]
            w = np.full((batch_size,), float(weight), np.float32)
            pos += batch_size
            emitted += 1
            yield (
                ParsedBatch(labels.astype(np.float32, copy=False), out_ids, out_vals, out_flds,
                            nnz.astype(np.int32, copy=False)),
                w,
            )
            continue
        # EOF, or a torn trailing record: poll for growth.
        if stop is not None and stop.is_set():
            return
        now = time.monotonic()
        if idle_since is None:
            idle_since = now
            if idle_flag is not None:
                idle_flag.set()
            # Turning idle: check the file is still the one being consumed.
            check_identity()
        elif idle_timeout_s > 0 and now - idle_since >= idle_timeout_s:
            return
        time.sleep(poll_s)
