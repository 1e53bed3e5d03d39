"""ctypes bindings of the native C++ libsvm parser — the counterpart of
``fast_tffm_tpu/data/native.py``.

``csrc/libsvm_parser.cpp`` (the port's own copy of the JAX package's
parser) builds with ``g++`` at first use (``ops/kernel_build.load_host``)
and parses with the contract of ``data/libsvm.parse_lines``, bit for bit.
Unlike the JAX loader, a missing ``g++`` or a failed build raises: a config
that names the native parser (``thread_num``) never runs the Python one in
its place.

  best_parser(threads)              the native parser (built at first use):
                                    a NativeParser, callable with
                                    parse_lines' signature
  native_batch_stream(parser, ...)  files → batches, read/split/parsed in C++
  scan_files(files)                 (non-blank lines, widest row)
  count_lines(files)                non-blank lines
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import ParsedBatch

__all__ = [
    "NativeParser",
    "usable_cores",
    "best_parser",
    "native_batch_stream",
    "scan_files",
    "count_lines",
]

_ERRORS = {
    1: "empty line",
    2: "bad label",
    3: "bad token",
    4: "feature id out of range",
    5: "row wider than max_nnz",
    6: "read error (I/O failure mid-file, not clean EOF)",
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p64 = ctypes.POINTER(ctypes.c_int64)
    c64, c32 = ctypes.c_int64, ctypes.c_int32
    lib.fm_parse_shape.restype = None
    lib.fm_parse_shape.argtypes = [ctypes.c_char_p, p64, p64]
    # buf, n, width, vocabulary_size, hash_feature_id, threads, labels, ids,
    # vals, fields, nnz, error_line
    lib.fm_parse_mt.restype = c32
    lib.fm_parse_mt.argtypes = [
        ctypes.c_char_p, c64, c64, c64, c32, c32, f32, i64, f32, i32, i32, p64,
    ]
    # path, shard_index, shard_count, shard_block, counter_start
    lib.fm_reader_open2.restype = ctypes.c_void_p
    lib.fm_reader_open2.argtypes = [ctypes.c_char_p, c64, c64, c64, c64]
    lib.fm_count_lines.restype = c64
    lib.fm_count_lines.argtypes = [ctypes.c_char_p]
    lib.fm_scan_file.restype = c32
    lib.fm_scan_file.argtypes = [ctypes.c_char_p, p64, p64]  # n_lines, widest
    lib.fm_reader_counter.restype = c64
    lib.fm_reader_counter.argtypes = [ctypes.c_void_p]
    lib.fm_reader_close.restype = None
    lib.fm_reader_close.argtypes = [ctypes.c_void_p]
    # reader, want, width, vocabulary_size, hash_feature_id, threads, labels,
    # ids (int64 | int32), vals, fields, nnz, error_code, error_line
    for name, ids in (("fm_reader_next", i64), ("fm_reader_next32", i32)):
        fn = getattr(lib, name)
        fn.restype = c64
        fn.argtypes = [
            ctypes.c_void_p, c64, c64, c64, c32, c32, f32, ids, f32, i32, i32,
            ctypes.POINTER(c32), p64,
        ]
    return lib


def usable_cores() -> int:
    """Cores THIS process may run on (its CPU affinity where the OS has
    one): a container pinned to 8 of 64 cores sizes its pool at 8."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


class NativeParser:
    """Callable with the signature of ``libsvm.parse_lines``.

    ``threads`` spreads the parse over an in-library std::thread pool
    inside one GIL-released ctypes call; ``threads=0`` (the default) uses
    every usable core.  The pool only spins up when a batch is large
    enough to pay for it (``parse_spans_mt`` in csrc/libsvm_parser.cpp)."""

    def __init__(self, lib: ctypes.CDLL, threads: int = 0):
        self._lib = lib
        if threads < 0:
            raise ValueError(f"threads must be >= 0 (0 = all cores), got {threads}")
        self.threads = int(threads) if threads > 0 else usable_cores()

    def __call__(
        self,
        lines: list[str],
        *,
        vocabulary_size: int,
        hash_feature_id_flag: bool = False,
        max_nnz: int | None = None,
    ) -> ParsedBatch:
        buf = ("\n".join(lines)).encode("utf-8")
        n = len(lines)
        if max_nnz is not None:
            width = max_nnz
        else:
            n_lines, widest = ctypes.c_int64(), ctypes.c_int64()
            self._lib.fm_parse_shape(buf, ctypes.byref(n_lines), ctypes.byref(widest))
            width = max(int(widest.value), 1)
        labels = np.zeros((n,), np.float32)
        ids = np.zeros((n, width), np.int64)
        vals = np.zeros((n, width), np.float32)
        fields = np.zeros((n, width), np.int32)
        nnz = np.zeros((n,), np.int32)
        err_line = ctypes.c_int64(-1)
        code = self._lib.fm_parse_mt(
            buf, n, width, vocabulary_size, 1 if hash_feature_id_flag else 0, self.threads,
            labels, ids, vals, fields, nnz, ctypes.byref(err_line),
        )
        if code != 0:
            raise ValueError(f"{_ERRORS.get(code, f'error {code}')} at line {err_line.value}")
        return ParsedBatch(labels=labels, ids=ids, vals=vals, fields=fields, nnz=nnz)


def best_parser(threads: int = 0) -> NativeParser:
    """The C++ parser, built from csrc/libsvm_parser.cpp at first use (or
    when the source is newer); a failed build raises.  (The JAX function of
    this name falls back to the Python parser; the port never does.)"""
    from fast_tffm_tpu_torch.ops.kernel_build import load_host

    return NativeParser(_bind(load_host("libsvm_parser")), threads)


def native_batch_stream(
    parser: NativeParser,
    files,
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int,
    epochs: int = 1,
    shard_index: int = 0,
    shard_count: int = 1,
    shard_block: int = 1,
    weights=None,
    drop_remainder: bool = False,
    pad_to_batches: int | None = None,
):
    """Stream (ParsedBatch, example_weights) batches entirely through C++.

    ``pipeline.batch_stream``'s contract (epoch repeats, per-file example
    weights, a zero-padded short final batch with weight-0 rows,
    ``drop_remainder``, ``pad_to_batches``), but the file reading, line
    splitting and parsing all happen inside ``fm_reader_next32`` /
    ``fm_reader_next``: Python only schedules files and yields the filled
    buffers (fresh ones per batch).  Batches span file and epoch boundaries
    as the Python stream's do.  Ids are int32 whenever the vocabulary fits
    (the device batch's dtype).  ``shard_*`` shard the lines block-cyclically
    by global non-blank line index, inside C++ (``pipeline``'s rule)."""
    from fast_tffm_tpu_torch.data.pipeline import check_shard_block, emit_assembled_tail

    check_shard_block(shard_block, epochs)
    if weights is not None and len(weights) != len(files):
        raise ValueError(f"weights has {len(weights)} entries for {len(files)} files")
    lib = parser._lib
    width = int(max_nnz)
    ids_dtype = np.int32 if vocabulary_size <= np.iinfo(np.int32).max else np.int64
    reader_next = lib.fm_reader_next32 if ids_dtype is np.int32 else lib.fm_reader_next

    def alloc():
        return (
            np.zeros((batch_size,), np.float32),
            np.zeros((batch_size, width), ids_dtype),
            np.zeros((batch_size, width), np.float32),
            np.zeros((batch_size, width), np.int32),
            np.zeros((batch_size,), np.int32),
            np.zeros((batch_size,), np.float32),
        )

    labels, ids, vals, fields, nnz, w = alloc()
    filled = emitted = 0
    counter = 0  # global non-blank line index, threaded through every file
    for _ in range(max(0, epochs)):
        for fi, path in enumerate(files):
            fw = 1.0 if weights is None else float(weights[fi])
            handle = lib.fm_reader_open2(os.fspath(path).encode(), shard_index, shard_count,
                                         max(1, shard_block), counter)
            if not handle:
                raise FileNotFoundError(path)
            try:
                while True:
                    ec, el = ctypes.c_int32(0), ctypes.c_int64(-1)
                    got = reader_next(
                        handle, batch_size - filled, width, vocabulary_size,
                        1 if hash_feature_id else 0, parser.threads,
                        labels[filled:], ids[filled:], vals[filled:], fields[filled:],
                        nnz[filled:], ctypes.byref(ec), ctypes.byref(el),
                    )
                    if got < 0:
                        # el is relative to this call, which writes at `filled`.
                        where = f" (batch row {filled + el.value})" if el.value >= 0 else ""
                        raise ValueError(
                            f"{_ERRORS.get(ec.value, f'error {ec.value}')} in {path}{where}"
                        )
                    w[filled : filled + got] = fw
                    filled += int(got)
                    if filled < batch_size:
                        break  # the file is exhausted
                    yield ParsedBatch(labels, ids, vals, fields, nnz), w
                    emitted += 1
                    labels, ids, vals, fields, nnz, w = alloc()
                    filled = 0
                    if pad_to_batches is not None and emitted >= pad_to_batches:
                        return
            finally:
                counter = int(lib.fm_reader_counter(handle))
                lib.fm_reader_close(handle)
    yield from emit_assembled_tail(
        alloc, (labels, ids, vals, fields, nnz, w), filled, emitted,
        drop_remainder, pad_to_batches,
    )


# (path, mtime_ns, size) -> (n_lines, widest): the width scan and the line
# counts of one run read each file once; an entry is stale once the file
# changes.
_scan_cache: dict[tuple[str, int, int], tuple[int, int]] = {}


def _scan_one(path) -> tuple[int, int]:
    from fast_tffm_tpu_torch.data.binary import is_fmb, read_header

    path = os.fspath(path)
    st = os.stat(path)
    key = (path, st.st_mtime_ns, st.st_size)
    hit = _scan_cache.get(key)
    if hit is not None:
        return hit
    if is_fmb(path):
        # The header alone: the widest ACTUAL row (0 in files written before
        # the field existed, where the stored width is the bound).
        h = read_header(path)
        out = (h.n_rows, h.max_row_nnz if h.max_row_nnz > 0 else h.width)
    else:
        n, w = ctypes.c_int64(), ctypes.c_int64()
        if best_parser()._lib.fm_scan_file(path.encode(), ctypes.byref(n), ctypes.byref(w)):
            raise OSError(f"cannot read {path}")
        out = (n.value, w.value)
    _scan_cache[key] = out
    return out


def scan_files(files) -> tuple[int, int]:
    """(total non-blank lines, widest row nnz) across ``files``: one C++
    streaming pass per text file, the header of an FMB file; per-file
    results cached by (path, mtime, size)."""
    total, widest = 0, 0
    for path in files:
        n, w = _scan_one(path)
        total += n
        widest = max(widest, w)
    return total, widest


def count_lines(files) -> int:
    """Total non-blank lines (FMB: rows) across ``files``: a cached scan
    where there is one, else the cheaper ``fm_count_lines`` (no tokenizing)."""
    from fast_tffm_tpu_torch.data.binary import is_fmb

    total = 0
    for path in files:
        path = os.fspath(path)
        st = os.stat(path)
        hit = _scan_cache.get((path, st.st_mtime_ns, st.st_size))
        if hit is not None:
            total += hit[0]
        elif is_fmb(path):
            total += _scan_one(path)[0]
        else:
            n = int(best_parser()._lib.fm_count_lines(path.encode()))
            if n < 0:
                raise OSError(f"cannot read {path}")
            total += n
    return total
