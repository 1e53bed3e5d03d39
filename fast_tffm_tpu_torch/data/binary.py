"""FMB packed binary datasets: parse libsvm text once, stream it by memmap —
the counterpart of ``fast_tffm_tpu/data/binary.py``, the same file format
(FMB1, ``tools/analysis/formats.lock.json``) byte for byte.

Layout (all offsets 64-byte aligned, little-endian):

    header  64 B   magic 'FMB1', version, n_rows, width, vocabulary_size,
                   hashed flag, ids itemsize, wire flags, source (size,
                   mtime_ns) for cache staleness, widest actual row
    labels  f32[n_rows]
    nnz     i32[n_rows]
    ids     i32[n_rows, width]
    vals    f32[n_rows, width]
    fields  i32[n_rows, width]

Rows are in text order (non-blank lines).  Feature hashing is applied at
write time; the header records the (vocabulary_size, hashed) pair the ids
were produced under, and readers refuse a mismatched configuration.

  open_fmb / is_fmb / read_header   memmap views, the magic, the header
  write_fmb(src, out, ...)          one text file → one FMB file (atomic)
  fmb_batch_stream(files, ...)      batch_stream's contract from memmaps,
                                    with a per-epoch shuffle
  ensure_fmb_cache(files, ...)      text files → fresh ``<file>.fmb`` caches
  fold_epoch_seed / draw_permutation  THE shuffle permutation, shared with
                                    data/device_cache.py and the JAX package
"""

from __future__ import annotations

import dataclasses
import os
import socket
import struct
import time
import uuid
from collections.abc import Iterator, Sequence
from typing import NamedTuple

import numpy as np

from fast_tffm_tpu_torch import resilience
from fast_tffm_tpu_torch.data.libsvm import ParsedBatch

__all__ = [
    "FMB_MAGIC",
    "FMB_VERSION",
    "FLAG_VALS_ALL_ONES",
    "FLAG_FIELDS_ALL_ZERO",
    "FmbHeader",
    "FmbFile",
    "is_fmb",
    "read_header",
    "fmb_wire_flags",
    "open_fmb",
    "write_fmb",
    "fmb_batch_stream",
    "ensure_fmb_cache",
    "fold_epoch_seed",
    "draw_permutation",
]

FMB_MAGIC = b"FMB1"
_ALIGN = 64
# magic, version, n_rows, width, vocabulary_size, hashed, ids_itemsize,
# flags, (pad), src_size, src_mtime_ns, max_row_nnz
_HEADER = struct.Struct("<4sIqqqBBB5xqqq")
FMB_VERSION = 2
# Wire-compressibility facts about every row, set at write time (version 2;
# version 1 files read as 0, "nothing promised").
FLAG_VALS_ALL_ONES = 1  # every row's vals are the 1.0-prefix/0.0-pad pattern
FLAG_FIELDS_ALL_ZERO = 2  # no row carries a field id


def _align(off: int) -> int:
    return (off + _ALIGN - 1) // _ALIGN * _ALIGN


def _section_offsets(n_rows: int, width: int, ids_itemsize: int):
    """(labels, nnz, ids, vals, fields, total_bytes) byte offsets."""
    labels = _ALIGN
    nnz = _align(labels + 4 * n_rows)
    ids = _align(nnz + 4 * n_rows)
    vals = _align(ids + ids_itemsize * n_rows * width)
    fields = _align(vals + 4 * n_rows * width)
    return labels, nnz, ids, vals, fields, _align(fields + 4 * n_rows * width)


class FmbHeader(NamedTuple):
    n_rows: int
    width: int
    vocabulary_size: int
    hashed: bool
    ids_itemsize: int
    src_size: int
    src_mtime_ns: int
    max_row_nnz: int  # widest actual row; 0 = unknown (files before the field)
    flags: int
    version: int


@dataclasses.dataclass
class FmbFile:
    """An open (read-only, memmapped) FMB dataset."""

    path: str
    header: FmbHeader
    labels: np.ndarray  # f32 [n_rows]
    nnz: np.ndarray  # i32 [n_rows]
    ids: np.ndarray  # i32 [n_rows, width]
    vals: np.ndarray  # f32 [n_rows, width]
    fields: np.ndarray  # i32 [n_rows, width]

    n_rows = property(lambda self: self.header.n_rows)
    width = property(lambda self: self.header.width)
    vocabulary_size = property(lambda self: self.header.vocabulary_size)
    hashed = property(lambda self: self.header.hashed)
    max_row_nnz = property(lambda self: self.header.max_row_nnz)


def is_fmb(path) -> bool:
    """True when ``path`` starts with the FMB magic (missing file → False)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == FMB_MAGIC
    except OSError:
        return False


def read_header(path) -> FmbHeader:
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
    if len(raw) < _HEADER.size:
        raise ValueError(f"{path}: truncated FMB header")
    magic, version, n_rows, width, vocab, hashed, isz, flags, src_size, src_mtime, widest = (
        _HEADER.unpack(raw)
    )
    if magic != FMB_MAGIC:
        raise ValueError(f"{path}: not an FMB file")
    if version not in (1, 2):
        raise ValueError(f"{path}: unsupported FMB version {version}")
    if isz != 4:
        raise ValueError(f"{path}: unsupported ids itemsize {isz} (int32 only)")
    return FmbHeader(n_rows, width, vocab, bool(hashed), isz, src_size, src_mtime, widest,
                     flags if version >= 2 else 0, version)


def fmb_wire_flags(files) -> tuple[bool, bool]:
    """(vals_all_ones, fields_all_zero) of a stream over ``files``: the AND
    of every file's v2 header flags (the JAX function).  A non-FMB or v1
    file makes both False: the packed wire leaves a section out only where
    every row was checked at convert time (and the packer checks again)."""
    ones = zero = True
    for path in files:
        try:
            if not is_fmb(path):
                return False, False
            flags = read_header(os.fspath(path)).flags
        except (OSError, ValueError):
            return False, False
        ones = ones and bool(flags & FLAG_VALS_ALL_ONES)
        zero = zero and bool(flags & FLAG_FIELDS_ALL_ZERO)
    return ones, zero


def _views(mm, n_rows: int, width: int):
    """(labels, nnz, ids, vals, fields) views of a whole-file uint8 map."""
    offs = _section_offsets(n_rows, width, 4)

    def view(off, dtype, shape):
        count = int(np.prod(shape))
        return mm[off : off + 4 * count].view(dtype).reshape(shape)

    return (
        view(offs[0], np.float32, (n_rows,)),
        view(offs[1], np.int32, (n_rows,)),
        view(offs[2], np.int32, (n_rows, width)),
        view(offs[3], np.float32, (n_rows, width)),
        view(offs[4], np.int32, (n_rows, width)),
    )


def open_fmb(path) -> FmbFile:
    """Memmap an FMB file into array views (no data is read eagerly)."""
    path = os.fspath(path)
    h = read_header(path)
    if os.path.getsize(path) < _section_offsets(h.n_rows, h.width, 4)[-1]:
        raise ValueError(f"{path}: truncated FMB file (partial write?)")
    mm = np.memmap(path, np.uint8, mode="r")
    return FmbFile(path, h, *_views(mm, h.n_rows, h.width))


def write_fmb(
    src_path,
    out_path,
    *,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    parser=None,
    chunk: int = 8192,
) -> str:
    """Convert ONE libsvm/libffm text file to an FMB file (atomic write:
    a process-unique temp file, then ``os.replace``).  ``max_nnz`` fixes
    the stored width (default: the file's widest row); ``parser`` defaults
    to the native parser.  The bytes are the JAX ``write_fmb``'s."""
    from fast_tffm_tpu_torch.data.native import best_parser, scan_files
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    src_path, out_path = os.fspath(src_path), os.fspath(out_path)
    if vocabulary_size > np.iinfo(np.int32).max:
        raise ValueError(
            f"vocabulary_size {vocabulary_size} exceeds int32; hash ids "
            "into range instead (hash_feature_id)"
        )
    st = os.stat(src_path)
    # A temp name unique across hosts and processes (caches on a shared
    # filesystem), landed by os.replace.
    tmp = f"{out_path}.{socket.gethostname()}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    try:
        # Probe writability before the scan: an unwritable cache location
        # must fail cheaply (ensure_fmb_cache falls back to text).
        with open(tmp, "wb"):
            pass
        n_rows, widest = scan_files([src_path])
        width = int(max_nnz) if max_nnz else max(1, widest)
        total = _section_offsets(n_rows, width, 4)[-1]
        with open(tmp, "r+b") as f:
            f.truncate(total)
        mm = np.memmap(tmp, np.uint8, mode="r+")
        labels, nnz, ids, vals, fields = _views(mm, n_rows, width)
        all_ones, fields_zero = True, True
        row = 0
        for parsed, _w in batch_stream(
            [src_path],
            batch_size=min(chunk, max(1, n_rows)),
            vocabulary_size=vocabulary_size,
            hash_feature_id=hash_feature_id,
            max_nnz=width,
            parser=parser if parser is not None else best_parser(),
        ):
            take = min(parsed.batch_size, n_rows - row)  # strip tail padding
            sl = slice(row, row + take)
            labels[sl] = parsed.labels[:take]
            nnz[sl] = parsed.nnz[:take]
            ids[sl] = parsed.ids[:take]
            vals[sl] = parsed.vals[:take]
            fields[sl] = parsed.fields[:take]
            if all_ones:  # 1.0 in the first nnz slots of each row, 0.0 beyond
                expect = np.arange(width) < parsed.nnz[:take, None]
                all_ones = bool(np.array_equal(parsed.vals[:take], expect.astype(np.float32)))
            fields_zero = fields_zero and not parsed.fields[:take].any()
            row += take
        if row != n_rows:
            raise RuntimeError(
                f"{src_path}: parsed {row} rows, scan said {n_rows} (file changed mid-convert?)"
            )
        flags = (FLAG_VALS_ALL_ONES if all_ones else 0) | (
            FLAG_FIELDS_ALL_ZERO if fields_zero else 0
        )
        # The header last: a crash mid-fill leaves a magic-less temp file.
        mm[: _HEADER.size] = np.frombuffer(
            _HEADER.pack(
                FMB_MAGIC, FMB_VERSION, n_rows, width, vocabulary_size,
                1 if hash_feature_id else 0, 4, flags, st.st_size, st.st_mtime_ns,
                max(1, widest),
            ),
            np.uint8,
        )
        mm.flush()
        del mm
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out_path


def _io_retry(fn, *, what: str, attempts: int, backoff_s: float, log):
    """Run ``fn``, retrying a transient OSError with a doubling backoff; the
    copies it wraps are idempotent (each overwrites the same destination
    slice), so a retry never loses or duplicates a row.  Each absorbed
    retry is a log line and a ``resilience.note_io_retry`` event (the run's
    kind=fault records); the last failure re-raises.
    ``resilience.maybe_io_fault`` inside the try is the ``io_error@N``
    injection point: an injected fault is absorbed like a real one."""
    delay = max(0.0, float(backoff_s))
    for attempt in range(max(0, int(attempts)) + 1):
        try:
            resilience.maybe_io_fault(what)
            return fn()
        except OSError as e:
            if attempt >= attempts:
                raise
            resilience.note_io_retry(what, e, attempt=attempt + 1)
            log(f"io retry {attempt + 1}/{attempts} on {what}: {e!r}")
            if delay:
                time.sleep(delay)
                delay *= 2


def fold_epoch_seed(shuffle_seed: int, epoch: int) -> int:
    """THE per-epoch seed fold of every shuffling surface: ``train`` makes
    one single-epoch stream per training epoch with this seed, and the
    device cache draws the same permutation."""
    return shuffle_seed * 1_000_003 + epoch


def draw_permutation(seed: int, epoch: int, n: int) -> np.ndarray:
    """THE permutation behind ``shuffle = true`` (numpy's PCG64 through
    ``default_rng((seed, epoch))``, as in the JAX package, so a shuffled
    epoch is the same permutation in both)."""
    return np.random.default_rng((seed, epoch)).permutation(n)


def _shard_runs(counter: int, n: int, shard_index: int, shard_count: int,
                block: int) -> Iterator[tuple[int, int]]:
    """The contiguous local ``[start, stop)`` row runs of this shard's
    selection in a file whose row 0 has global index ``counter``: global
    row g is ours iff ``(g // block) % shard_count == shard_index``, so the
    owned rows are runs of ``block`` every ``shard_count · block`` rows
    (each copy stays a memcpy)."""
    if shard_count == 1:
        if n > 0:
            yield 0, n
        return
    block = max(1, block)
    period = shard_count * block
    lo, hi = counter, counter + n
    m = (lo - shard_index * block) // period  # the first run touching lo
    while True:
        start = m * period + shard_index * block
        if start >= hi:
            return
        s, e = max(start, lo), min(start + block, hi)
        if s < e:
            yield s - counter, e - counter
        m += 1


def fmb_batch_stream(
    files: Sequence[str],
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    epochs: int = 1,
    shard_index: int = 0,
    shard_count: int = 1,
    shard_block: int = 1,
    weights: Sequence[float] | None = None,
    drop_remainder: bool = False,
    pad_to_batches: int | None = None,
    shuffle_seed: int | None = None,
    skip_rows: int = 0,
    io_retries: int = 3,
    io_retry_backoff_s: float = 0.05,
    log=print,
) -> Iterator[tuple[ParsedBatch, np.ndarray]]:
    """Stream (ParsedBatch, example_weights) from FMB files.

    ``pipeline.batch_stream``'s contract (epoch repeats, per-file example
    weights, a zero-padded short final batch with weight-0 rows,
    ``drop_remainder``, ``pad_to_batches``), every copy a memmap slice into
    fresh buffers per batch; the batches are bit-identical to the text
    streams' over the same source rows.

    ``shuffle_seed`` shuffles each epoch e: one permutation of ALL rows from
    ``draw_permutation(shuffle_seed, e, rows)`` is the epoch's row order,
    so every epoch visits every row once.  ``skip_rows`` (a whole number
    of batches) is the exact-position resume's seek: the first rows of the
    stream's order (the permuted order when shuffled, the permutation drawn
    from the seed as without a seek) are passed over without a copy, and
    count as emitted for ``pad_to_batches``.  Reads retry a transient
    OSError ``io_retries`` times (backoff doubling from
    ``io_retry_backoff_s``), each retry a line to ``log``.

    ``shard_*`` select this shard's rows by ``pipeline``'s block-cyclic
    rule on the global row index (across files); shuffled, the rule picks
    output SLOTS of the epoch's permutation, so the shards assemble the
    same global batches from disjoint slot ranges.  ``skip_rows`` counts
    rows of this shard's selection."""
    from fast_tffm_tpu_torch.data.pipeline import check_shard_block, emit_assembled_tail

    check_shard_block(shard_block, epochs)
    if weights is not None and len(weights) != len(files):
        raise ValueError(f"weights has {len(weights)} entries for {len(files)} files")
    if skip_rows < 0 or skip_rows % batch_size:
        raise ValueError(
            f"skip_rows must be a non-negative whole number of batches "
            f"(batch_size {batch_size}), got {skip_rows}"
        )

    def _retry(fn, what):
        return _io_retry(fn, what=what, attempts=io_retries, backoff_s=io_retry_backoff_s, log=log)

    fs = [_retry(lambda p=p: open_fmb(p), f"fmb-open:{p}") for p in files]
    read_what = [f"fmb-read:{f.path}" for f in fs]
    for f in fs:
        if f.hashed != bool(hash_feature_id):
            raise ValueError(
                f"{f.path}: written with hash_feature_id={f.hashed}, "
                f"requested {bool(hash_feature_id)} — re-convert the file"
            )
        if f.hashed and f.vocabulary_size != vocabulary_size:
            raise ValueError(
                f"{f.path}: hashed into vocabulary_size={f.vocabulary_size}, "
                f"requested {vocabulary_size} — re-convert the file"
            )
        if not f.hashed and f.vocabulary_size > vocabulary_size:
            raise ValueError(
                f"{f.path}: ids validated against vocabulary_size="
                f"{f.vocabulary_size} > requested {vocabulary_size} — "
                "re-convert the file"
            )
    width = int(max_nnz) if max_nnz else max([f.width for f in fs] or [1])
    for f in fs:
        # A stored width wider than the request is the converter's padding;
        # only an actual row wider than it is an error.  The copies below
        # clamp the padding columns off.
        if f.width > width:
            widest = f.max_row_nnz or (int(f.nnz.max()) if f.n_rows else 0)
            if widest > width:
                raise ValueError(f"{f.path}: rows up to {widest} features > max_nnz={width}")

    def alloc():
        return (
            np.zeros((batch_size,), np.float32),
            np.zeros((batch_size, width), np.int32),
            np.zeros((batch_size, width), np.float32),
            np.zeros((batch_size, width), np.int32),
            np.zeros((batch_size,), np.int32),
            np.zeros((batch_size,), np.float32),
        )

    bufs = list(alloc())  # labels, ids, vals, fields, nnz, weights
    filled = 0
    emitted = skip_rows // batch_size  # skipped batches count as emitted
    skip_left = skip_rows

    def copy_rows(fi: int, src, dst) -> None:
        """Rows ``src`` of file ``fi`` into batch slots ``dst`` (slices or
        index arrays), retried as one idempotent read."""
        f, cw = fs[fi], min(fs[fi].width, width)
        labels, ids, vals, flds, nnz, w = bufs

        def copy():
            labels[dst] = f.labels[src]
            nnz[dst] = f.nnz[src]
            ids[dst, :cw] = f.ids[src, :cw]
            vals[dst, :cw] = f.vals[src, :cw]
            flds[dst, :cw] = f.fields[src, :cw]
            w[dst] = 1.0 if weights is None else float(weights[fi])

        _retry(copy, read_what[fi])

    def cycle_buffers():
        """The full batch out, fresh zeroed buffers in (their zeros are
        the column and tail padding, and no yielded batch is reused)."""
        nonlocal bufs, filled, emitted
        out = ParsedBatch(*bufs[:5]), bufs[5]
        bufs = list(alloc())
        filled = 0
        emitted += 1
        return out

    def done() -> bool:
        return pad_to_batches is not None and emitted >= pad_to_batches

    if shuffle_seed is not None:
        bounds = np.cumsum([0] + [f.n_rows for f in fs])
        total = int(bounds[-1])
        slot_base = 0  # the global slot counter across epochs (the cyclic rule's)
        block = max(1, shard_block)
        for e in range(max(0, epochs)):
            rows = draw_permutation(shuffle_seed, e, total)  # source row per slot
            if shard_count > 1:
                slots = np.arange(total, dtype=np.int64)
                rows = rows[((slot_base + slots) // block) % shard_count == shard_index]
            slot_base += total
            # A seek drops the consumed prefix of the redrawn permutation:
            # slot j of a resumed epoch is slot j of the original.
            adv = min(skip_left, len(rows))
            rows, skip_left = rows[adv:], skip_left - adv
            pos = 0
            while pos < len(rows):
                take = min(len(rows) - pos, batch_size - filled)
                chunk = rows[pos : pos + take]
                fidx = np.searchsorted(bounds, chunk, side="right") - 1
                local = chunk - bounds[fidx]
                for fi in np.unique(fidx):
                    m = fidx == fi
                    copy_rows(int(fi), local[m], np.flatnonzero(m) + filled)
                filled += take
                pos += take
                if filled == batch_size:
                    yield cycle_buffers()
                    if done():
                        return
    else:
        counter = 0  # the global row index, across files and epochs
        for _ in range(max(0, epochs)):
            for fi, f in enumerate(fs):
                for lo, hi in _shard_runs(counter, f.n_rows, shard_index, shard_count,
                                          shard_block):
                    adv = min(skip_left, hi - lo)  # the seek: no copy of skipped rows
                    skip_left -= adv
                    lo += adv
                    while lo < hi:
                        take = min(hi - lo, batch_size - filled)
                        copy_rows(fi, slice(lo, lo + take), slice(filled, filled + take))
                        filled += take
                        lo += take
                        if filled == batch_size:
                            yield cycle_buffers()
                            if done():
                                return
                counter += f.n_rows
    yield from emit_assembled_tail(alloc, tuple(bufs), filled, emitted, drop_remainder,
                                   pad_to_batches)


def _writable(cache_path: str) -> bool:
    """Can a file be created beside ``cache_path``?  (A unique probe file;
    the cache itself is never touched non-atomically.)"""
    probe = f"{cache_path}.{socket.gethostname()}.{os.getpid()}.{uuid.uuid4().hex[:8]}.probe"
    try:
        with open(probe, "wb"):
            pass
    except OSError:
        return False
    try:
        os.remove(probe)
    except OSError:
        pass
    return True


# Cache paths whose build failed in this process (ENOSPC, quota, …): later
# ensure_fmb_cache calls skip the rebuild and fall back to text at once.
_BUILD_FAILED: set[str] = set()


def ensure_fmb_cache(
    files: Sequence[str],
    *,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    parser=None,
    log=print,
    wait_for_peer: float = 0.0,
) -> tuple[str, ...]:
    """Map text files to fresh ``<file>.fmb`` caches, converting as needed.

    Files that already are FMB pass through.  A cache is reused only while
    its header matches the source's (size, mtime_ns) and the requested
    (vocabulary_size, hash, max_nnz); anything else rebuilds it (atomic
    replace, so concurrent builders race benignly).

    An unwritable cache location is not fatal: the whole list comes back
    as the text files, with a log line that says so, and the stream parses
    them; the batches are the same either way.  When the list mixes in
    FMB files that have no text form, that is an OSError naming them.

    ``wait_for_peer`` > 0 (a non-lead rank of a multi-process run,
    ``[Train] binary_cache_wait``) polls up to that many seconds, one
    budget for the whole list, for another process to finish a stale
    cache before building it here: on a shared filesystem the lead builds
    once.  It waits only where a cache can be written at all."""

    def check_fresh(cache, st):
        try:
            if not is_fmb(cache):
                return False
            h = read_header(cache)
        except (ValueError, OSError):
            return False
        return (
            h.src_size == st.st_size
            and h.src_mtime_ns == st.st_mtime_ns
            and h.version >= 2
            and h.hashed == bool(hash_feature_id)
            and (h.vocabulary_size == vocabulary_size if h.hashed
                 else h.vocabulary_size <= vocabulary_size)
            and (
                max_nnz is None
                or h.width <= max_nnz
                or (h.max_row_nnz > 0 and h.max_row_nnz <= max_nnz)
            )
        )

    def fall_back_to_text(path, cache, err):
        passthrough = [os.fspath(p) for p in files if is_fmb(p)]
        if passthrough:
            listed = "\n".join(f"    {p}" for p in passthrough)
            raise OSError(
                f"binary_cache: cannot build the FMB cache for {path!r} ({err}), and "
                "the whole stream cannot fall back to text because these input "
                f"entries are pre-built FMB with no text form:\n{listed}\n"
                f"  fix one side: make {os.path.dirname(cache) or '.'!r} writable "
                f"(or pre-convert {path!r}), or make the input list all-text / all-FMB"
            )
        log(f"binary_cache: cannot write {cache} ({err}); streaming text for all "
            "input files instead")
        return tuple(os.fspath(p) for p in files)

    out: list[str] = []
    deadline = time.monotonic() + wait_for_peer if wait_for_peer > 0 else 0.0
    for path in files:
        path = os.fspath(path)
        if is_fmb(path):
            out.append(path)
            continue
        cache = path + ".fmb"
        st = os.stat(path)
        fresh = check_fresh(cache, st)
        if not fresh and wait_for_peer > 0 and cache not in _BUILD_FAILED and _writable(cache):
            while not fresh and time.monotonic() < deadline:
                time.sleep(min(1.0, wait_for_peer))
                fresh = check_fresh(cache, st)
        if not fresh:
            if cache in _BUILD_FAILED:
                return fall_back_to_text(path, cache, "previous build failed")
            log(f"building binary cache {cache}")
            try:
                write_fmb(path, cache, vocabulary_size=vocabulary_size,
                          hash_feature_id=hash_feature_id, max_nnz=max_nnz, parser=parser)
            except OSError as e:
                _BUILD_FAILED.add(cache)
                return fall_back_to_text(path, cache, e)
        out.append(cache)
    return tuple(out)
