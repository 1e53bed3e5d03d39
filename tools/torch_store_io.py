"""Row I/O of the tiered store's files (``fast_tffm_tpu_torch/paramstore/
store.py``): a memmap against ``os.pread`` / ``os.pwrite``, on the host.

    python tools/torch_store_io.py [--ids N] [--out FILE] [--dir DIR]

Two stores at baseline5's widths (a [V, 9] table and a [V, 9] element
accumulator, float32) in a temporary directory under ``--dir`` (default:
the system's temporary directory): a materialized one at V = 2^20 (every
page written, as ``materialize = auto`` makes it) and a lazy one at V =
2^31 - 1 (sparse files).  The ids are ``--ids`` (default 60,000, the rows
a step of the ``tiered`` phase of ``chip_smoke.py`` misses) unique ids drawn
uniformly from the vocabulary with numpy seed 0; the lazy store's rows are
written first, so every read is of written rows.  Each strategy reads and
writes those rows of ``table.dat`` (5 repetitions, median ms):

  * ``memmap``: fancy indexing of a ``np.memmap`` (the materialized store
    only: over the sparse 77 GB files it faults a page at a time);
  * ``pread_runs``: one ``pread`` / ``pwrite`` per run of consecutive ids;
  * ``pread_spans``: ids closer than one 4 KiB page merged into one span,
    one ``pread`` per span and the rows picked out; a write reads the span,
    puts its rows in and writes the span back;
  * ``store``: ``ColdStore.read_rows`` / ``write_rows`` of the checkout
    (both files and the bitmap), as training calls them.

Every strategy's read must give back the rows written; it prints one JSON
object and writes it to ``--out`` too.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

D = A = 9
PAGE = 4096


def _spans(sid, gap_rows: int) -> list:
    import numpy as np

    br = np.flatnonzero(np.diff(sid) > gap_rows) + 1
    return list(zip(np.concatenate([[0], br]).tolist(), np.concatenate([br, [sid.size]]).tolist()))


def pread_rows(path: str, ids, width: int, gap_rows: int):
    import numpy as np

    order = np.argsort(ids, kind="stable")
    sid = ids[order]
    got = np.empty((ids.size, width), np.float32)
    fd = os.open(path, os.O_RDONLY)
    try:
        for lo, hi in _spans(sid, gap_rows):
            a, b = int(sid[lo]), int(sid[hi - 1]) + 1
            span = np.frombuffer(os.pread(fd, (b - a) * width * 4, a * width * 4),
                                 np.float32).reshape(b - a, width)
            got[lo:hi] = span[sid[lo:hi] - a]
    finally:
        os.close(fd)
    out = np.empty_like(got)
    out[order] = got
    return out


def pwrite_rows(path: str, ids, rows, width: int, gap_rows: int) -> None:
    import numpy as np

    order = np.argsort(ids, kind="stable")
    sid, data = ids[order], rows[order]
    fd = os.open(path, os.O_RDWR)
    try:
        for lo, hi in _spans(sid, gap_rows):
            a, b = int(sid[lo]), int(sid[hi - 1]) + 1
            if b - a == hi - lo:
                os.pwrite(fd, data[lo:hi].tobytes(), a * width * 4)
                continue
            span = np.frombuffer(bytearray(os.pread(fd, (b - a) * width * 4, a * width * 4)),
                                 np.float32).reshape(b - a, width)
            span[sid[lo:hi] - a] = data[lo:hi]
            os.pwrite(fd, span.tobytes(), a * width * 4)
    finally:
        os.close(fd)


def _ms(fn, reps: int = 5) -> float:
    import numpy as np

    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def measure(root: str, n_ids: int) -> dict:
    import numpy as np

    from fast_tffm_tpu_torch.paramstore.store import ColdStore

    rng = np.random.default_rng(0)
    out = {}
    for name, vocab, materialized in (("materialized_2^20", 1 << 20, True),
                                      ("lazy_2^31-1", (1 << 31) - 1, False)):
        path = os.path.join(root, name)
        init = {}
        if materialized:
            init = {"init_table": rng.uniform(-0.01, 0.01, (vocab, D)).astype(np.float32),
                    "init_accum_arr": np.full((vocab, A), 0.1, np.float32)}
        t0 = time.perf_counter()
        store = ColdStore.create(path, vocab=vocab, row_dim=D, accum_width=A, seed=0,
                                 init_range=0.01, init_accum=0.1, **init)
        create_s = time.perf_counter() - t0
        ids = np.unique(rng.integers(0, vocab, n_ids, dtype=np.int64))
        rows = rng.uniform(-0.01, 0.01, (ids.size, D)).astype(np.float32)
        table = os.path.join(path, "table.dat")
        pwrite_rows(table, ids, rows, D, 0)
        res = {"vocab": vocab, "ids": int(ids.size), "create_s": create_s}
        strategies = {"pread_runs": 0, "pread_spans": PAGE // (4 * D)}
        for label, gap in strategies.items():
            if not np.array_equal(pread_rows(table, ids, D, gap), rows):
                raise AssertionError(f"{name} {label}: read back differs")
            res[label] = {"read_ms": _ms(lambda g=gap: pread_rows(table, ids, D, g)),
                          "write_ms": _ms(lambda g=gap: pwrite_rows(table, ids, rows, D, g))}
        if materialized:
            mm = np.memmap(table, np.float32, mode="r+", shape=(vocab, D))
            if not np.array_equal(mm[ids], rows):
                raise AssertionError(f"{name} memmap: read back differs")

            def mm_write():
                mm[ids] = rows

            res["memmap"] = {"read_ms": _ms(lambda: mm[ids]), "write_ms": _ms(mm_write)}
            del mm
        acc = np.full((ids.size, A), 0.2, np.float32)
        store.write_rows(ids, rows, acc)
        got = store.read_rows(ids)
        if not (np.array_equal(got[0], rows) and np.array_equal(got[1], acc)):
            raise AssertionError(f"{name} store: read back differs")
        res["store"] = {"read_ms": _ms(lambda: store.read_rows(ids)),
                        "write_ms": _ms(lambda: store.write_rows(ids, rows, acc))}
        store.close()
        shutil.rmtree(path)
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ids", type=int, default=60000, help="ids drawn per store")
    ap.add_argument("--dir", default=None, help="where the stores are made")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        fs = os.statvfs(tmp)
        result = {"host": platform.node(), "cpus": os.cpu_count(),
                  "dir_free_bytes": fs.f_bavail * fs.f_frsize, **measure(tmp, args.ids)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        tmp_out = f"{args.out}.{os.getpid()}.tmp"
        with open(tmp_out, "w") as f:
            f.write(text + "\n")
        os.replace(tmp_out, args.out)  # a reader sees the whole file or none
    return 0


if __name__ == "__main__":
    sys.exit(main())
