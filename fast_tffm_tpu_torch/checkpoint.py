"""Checkpoints — the counterpart of ``fast_tffm_tpu/checkpoint.py``, in its
two formats.

**npz.**  Save: ``save_checkpoint`` writes what ``fast_tffm_tpu/checkpoint.py::_save_npz``
writes — members ``table`` [V, D], ``table_accum``, ``step``, ``save_id``,
``published_at``, ``dense_{i}`` / ``dense_accum_{i}`` and, given a
``cursor``, ``input_cursor`` (the exact input position the state stands
at, canonical JSON bytes) — streaming each array device→host in bounded
row chunks into a ZIP_STORED npz, to ``<path>.tmp`` first and then
``os.replace`` onto ``path``, after removing any sibling delta files.
Either package restores what the other saved, cursor included.

**orbax.**  The directory ``ocp.StandardCheckpointer`` writes (OCDBT +
zarr v2, read and written by ``ocdbt.py`` without tensorstore): arrays
``table``, ``table_opt.accum``, ``dense.<name>``, ``dense_opt.accum.<name>``
and ``step``, the tree in ``_METADATA``, and the sidecars
``<dir>.TRAIN_STEP`` and ``<dir>.INPUT_CURSOR`` beside it.  Each process
writes its own rows into ``ocdbt.process_<i>/`` (a ``RowShard``: one chunk
per row shard, no gather); after a barrier process 0 writes the root
database that references every process's data files and the metadata.  A
save goes to ``<dir>.orbax-checkpoint-tmp`` and is renamed into place
after the old directory is removed (orbax 0.11 removes the old directory
when its save starts; here it goes just before the rename), then the
sidecars follow.  A reader may therefore find no directory, or open one
that is removed under it: that read raises, and the serving watcher
retries on its next tick.  A restore reads only the chunks it needs
(``restore_rows``: one rank's row range).

Restore: ``restore_checkpoint`` reads the parameters (``table``, ``step``,
the dense leaves) for scoring and, given the accumulator width a training
config expects, the Adagrad accumulators too; ``read_input_cursor`` reads
the cursor (None for a checkpoint saved without one).

Both hold the logical arrays whatever layout the run trains in: a fused
run saves ``trainer.unpack_state`` of its state (a [V, D] table and a
[V, 1] accumulator) and packs what it restores, so rows, packed and fused
runs restore each other's checkpoints, as in the JAX package.

Refused rather than misread: a tiered parameter-store checkpoint (its
``table`` is only the hot tier), a delta that does not chain from its
base, an orbax directory whose padded vocabulary does not fit the mesh a
multi-process run restores it on, and for training an accumulator of the
wrong granularity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import time
import uuid
import zipfile

import numpy as np
import torch

from fast_tffm_tpu_torch.ocdbt import (
    OcdbtStore,
    OcdbtWriter,
    ZarrArray,
    chunk_key,
    write_root,
    zarray_bytes,
)
from fast_tffm_tpu_torch.resilience import maybe_publish_fault
from fast_tffm_tpu_torch.trainer import TrainState
from fast_tffm_tpu_torch.weights import from_jax_arrays

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "restore_rows",
    "orbax_table_shape",
    "RowShard",
    "read_input_cursor",
    "checkpoint_signature",
    "latest_step",
    "delta_paths",
    "DEFAULT_CHUNK_BYTES",
    "TornCheckpointError",
]

DEFAULT_CHUNK_BYTES = 64 << 20  # host staging bound per array slice
_DELTA_RE = re.compile(r"\.delta-(\d{4})\.npz$")


class TornCheckpointError(ValueError):
    """A checkpoint file that does not read whole: a torn or truncated write
    (a complete save, tmp + os.replace, never looks like this)."""


def _torn_error(path: str, what: str, exc: Exception) -> ValueError:
    return TornCheckpointError(
        f"checkpoint file {path!r} is unreadable ({what}: {exc}) — "
        "truncated or torn write?  Saves are atomic (tmp + os.replace), so "
        "a complete save never looks like this; delete or replace the file"
    )


def _open_npz(path: str):
    """np.load with torn-file errors that name the file."""
    try:
        return np.load(path, allow_pickle=False)
    except (zipfile.BadZipFile, ValueError, OSError, EOFError) as e:
        if isinstance(e, OSError) and not os.path.exists(path):
            raise
        raise _torn_error(path, type(e).__name__, e) from e


def delta_paths(path: str) -> list[str]:
    """Existing ``<path>.delta-NNNN.npz`` files, in chain (seq) order."""
    out = []
    # glob.escape: a model_file with glob metacharacters must still find
    # its own deltas.
    for p in glob.glob(glob.escape(path) + ".delta-*.npz"):
        m = _DELTA_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return [p for _, p in sorted(out)]


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _npy_header_bytes(shape, dtype) -> bytes:
    from numpy.lib import format as npf

    buf = io.BytesIO()
    npf.write_array_header_1_0(
        buf,
        {"descr": npf.dtype_to_descr(np.dtype(dtype)), "fortran_order": False,
         "shape": tuple(int(s) for s in shape)},
    )
    return buf.getvalue()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _array_row_chunks(arr, chunk_bytes: int, staging=None):
    """C-contiguous host chunks of ``arr`` (a tensor on any device, or a
    numpy value), never staging more than ~chunk_bytes on the host at once:
    the per-chunk copy is where the device→host transfer happens.  With
    ``staging`` (a pinned uint8 tensor) a CUDA tensor's chunks are copied
    into it on the current stream, which is synchronised before the chunk
    is handed out: each chunk is then a view of the buffer, valid until
    the next one is drawn."""
    shape = tuple(arr.shape)
    if not shape:
        yield np.ascontiguousarray(_host(arr))
        return
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    row_bytes = itemsize * int(np.prod(shape[1:], dtype=np.int64) or 1)
    pinned = (staging is not None and isinstance(arr, torch.Tensor)
              and arr.device.type == "cuda" and staging.numel() >= row_bytes)
    if pinned:
        chunk_bytes = min(chunk_bytes, staging.numel())
    rows = max(1, chunk_bytes // max(1, row_bytes))
    for lo in range(0, shape[0], rows):
        part = arr[lo : lo + rows]
        if not pinned:
            yield np.ascontiguousarray(_host(part))
            continue
        buf = staging[: part.numel() * itemsize].view(part.dtype).view(part.shape)
        buf.copy_(part, non_blocking=True)
        torch.cuda.current_stream(part.device).synchronize()
        yield buf.numpy()


def _np_dtype(arr) -> np.dtype:
    if isinstance(arr, torch.Tensor):
        return torch.empty((), dtype=arr.dtype).numpy().dtype
    return arr.dtype


def _write_npz_streaming(fileobj, entries: dict, chunk_bytes: int, timings: dict | None = None,
                         staging=None) -> int:
    """Write a np.load-compatible npz (ZIP_STORED) from ``entries`` (name →
    tensor or numpy value), streaming each array in bounded chunks; returns
    the payload bytes.  ``timings`` accumulates ``d2h_ms`` (drawing each
    chunk: the device→host copy) and ``write_ms`` (writing it), as the JAX
    writer does."""
    total = 0
    with zipfile.ZipFile(fileobj, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in entries.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                member.write(_npy_header_bytes(arr.shape, _np_dtype(arr)))
                it = _array_row_chunks(arr, chunk_bytes, staging)
                while True:
                    t0 = time.perf_counter()
                    chunk = next(it, None)
                    t1 = time.perf_counter()
                    if chunk is None:
                        break
                    member.write(chunk)
                    total += chunk.nbytes
                    if timings is not None:
                        t2 = time.perf_counter()
                        timings["d2h_ms"] = timings.get("d2h_ms", 0.0) + (t1 - t0) * 1e3
                        timings["write_ms"] = timings.get("write_ms", 0.0) + (t2 - t1) * 1e3
    return total


def _cursor_entry(cursor: dict) -> np.ndarray:
    """The input cursor as an npz member: canonical JSON bytes (sort_keys,
    so equal cursors are byte-equal members, as the JAX package writes)."""
    return np.frombuffer(json.dumps(cursor, sort_keys=True).encode(), np.uint8)


def save_checkpoint(
    path: str,
    state,
    format: str = "auto",
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    save_id: str | None = None,
    cursor: dict | None = None,
    timings: dict | None = None,
    staging=None,
    dense_names=(),
    runtime=None,
) -> int:
    """Write ``state`` (a logical TrainState, or for a multi-process orbax
    save this process's ``RowShard``) to ``path``; returns the payload
    bytes this process wrote.

    ``format``: ``npz`` | ``orbax`` | ``auto`` (orbax for a ``.orbax``
    suffix, a trailing ``/`` or an existing directory, else npz).  npz: an
    atomic file of ``_save_npz``'s members; ``save_id`` is the delta
    chain's content anchor (fresh when None).  orbax: ``dense_names`` names
    the dense leaves (the JAX tree's keys); with an active ``runtime``
    every process calls this at the same boundary (see ``_save_orbax``).
    ``cursor`` (``training.train``'s input position: epoch, batch in
    epoch, the input's identity) becomes the ``input_cursor`` member or
    sidecar; a save without one writes the pre-cursor layout (an orbax
    save removes a stale sidecar), which both packages resume from the
    first file.  ``timings`` and ``staging`` as in ``_write_npz_streaming``."""
    if format == "auto":
        format = "orbax" if path.endswith((".orbax", "/")) or os.path.isdir(path) else "npz"
    if format == "orbax":
        return _save_orbax(path.rstrip("/"), state, chunk_bytes=chunk_bytes, cursor=cursor,
                           timings=timings, staging=staging, dense_names=tuple(dense_names),
                           runtime=runtime)
    if format != "npz":
        raise ValueError(f"unknown checkpoint format {format!r}")
    if isinstance(state, RowShard):
        raise ValueError("an npz save writes the whole logical state (one writer); "
                         "row shards are an orbax save's")
    if state.layout != "rows":
        raise ValueError(
            f"save_checkpoint writes the logical arrays; unpack the {state.layout} "
            "state first (trainer.unpack_state)"
        )
    if state.table_accum is None:
        raise ValueError("save_checkpoint needs a training state (table_accum is missing)")
    entries = {
        "table": state.table,
        "table_accum": state.table_accum,
        # int32, the JAX TrainState's step dtype.
        "step": np.asarray(state.step, np.int32),
        "save_id": np.frombuffer((save_id or uuid.uuid4().hex).encode(), np.uint8),
        # Publish event time (wall clock), the anchor of the JAX package's
        # freshness metrics; stamped at write start.
        "published_at": np.asarray(time.time(), np.float64),
    }
    if cursor is not None:
        entries["input_cursor"] = _cursor_entry(cursor)
    for i, (p, a) in enumerate(zip(state.dense, state.dense_accum, strict=True)):
        entries[f"dense_{i}"] = p
        entries[f"dense_accum_{i}"] = a
    tmp = path + ".tmp"
    dirpart = os.path.dirname(path)
    if dirpart:
        os.makedirs(dirpart, exist_ok=True)
    with open(tmp, "wb") as f:
        nbytes = _write_npz_streaming(f, entries, chunk_bytes, timings, staging)
    # Reset the delta chain BEFORE the publish: a crash between the two
    # leaves the old base alone, still a complete checkpoint.  Newest delta
    # first: every state a reader (the serving reload) or a crash can see
    # in between is the base with a prefix of its chain, never a chain
    # with a hole.
    for dp in reversed(delta_paths(path)):
        try:
            os.remove(dp)
        except OSError:
            pass
    # The kill_publish@K injection point: a crash between the finished tmp
    # file and the rename leaves the previous checkpoint whole.
    maybe_publish_fault(path)
    os.replace(tmp, path)
    return nbytes


# ---------------------------------------------------------------------------
# orbax directories
# ---------------------------------------------------------------------------

_STEP_SIDECAR = "TRAIN_STEP"
_CURSOR_SIDECAR = "INPUT_CURSOR"
_TMP_SUFFIX = ".orbax-checkpoint-tmp"
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


@dataclasses.dataclass
class RowShard:
    """One process's share of a multi-process orbax save: ``state`` holds
    rows ``[offset, offset + n)`` of the logical ``[total, D]`` table and
    accumulator (rows layout), and the dense leaves and step, which only
    process 0 writes.  ``writes_rows`` is False on every replica of a row
    shard but one (the data coordinate 0)."""

    state: TrainState
    offset: int
    total: int
    writes_rows: bool = True


def _process_db(root: str, process: int) -> str:
    return os.path.join(root, f"ocdbt.process_{process}")


def _put_array(db, name: str, arr, chunk_bytes: int, timings, staging, *, index: int = 0,
               shape=None, chunks=None) -> int:
    """Chunk ``index`` (along axis 0) of array ``name``: ``arr`` (a tensor
    on any device, or a numpy value) streamed in bounded row chunks, and
    the ``.zarray`` when ``shape`` (the global shape) is given."""
    dtype = _np_dtype(arr)
    if dtype not in (np.float32, np.int32, np.int64):
        raise ValueError(f"{name}: no orbax dtype for {dtype}")
    if shape is not None:
        db.put(f"{name}/.zarray", zarray_bytes(shape, chunks, dtype))
    nbytes = int(np.prod(arr.shape, dtype=np.int64)) * dtype.itemsize
    it = _array_row_chunks(arr, chunk_bytes, staging)

    def timed():
        while True:
            t0 = time.perf_counter()
            c = next(it, None)
            t1 = time.perf_counter()
            if c is None:
                return
            yield c
            if timings is not None:
                timings["d2h_ms"] = timings.get("d2h_ms", 0.0) + (t1 - t0) * 1e3
                timings["write_ms"] = (timings.get("write_ms", 0.0)
                                       + (time.perf_counter() - t1) * 1e3)

    db.put_chunks(chunk_key(name, (index,) + (0,) * (len(arr.shape) - 1) if arr.shape else ()),
                  nbytes, timed())
    return nbytes


def _tree_entry(keys: tuple, *, write_shape=None) -> tuple[str, dict]:
    meta = ({"value_type": "jax.Array", "skip_deserialize": False,
             "write_shape": [int(c) for c in write_shape]}
            if write_shape is not None else {"value_type": "Dict", "skip_deserialize": True})
    return str(keys), {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                       "value_metadata": meta}


def _metadata_files(root: str, arrays: list[tuple[tuple, tuple, tuple]], dense_names) -> None:
    """``_METADATA`` (the JAX TrainState's tree: ``table``, ``table_opt``
    ``accum``, ``dense``, ``dense_opt`` ``accum``, ``step``; an empty dense
    dict as orbax records one), ``array_metadatas/process_0`` and
    ``_CHECKPOINT_METADATA``, as a single-device JAX save writes them.
    ``arrays``: (tree keys, global shape, chunk shape)."""
    chunk = {keys: c for keys, _, c in arrays}
    tree = [_tree_entry(("table",), write_shape=chunk[("table",)]),
            _tree_entry(("table_opt", "accum"), write_shape=chunk[("table_opt", "accum")])]
    if dense_names:
        tree += [_tree_entry(("dense", n), write_shape=chunk[("dense", n)]) for n in dense_names]
        tree += [_tree_entry(("dense_opt", "accum", n),
                             write_shape=chunk[("dense_opt", "accum", n)]) for n in dense_names]
    else:
        tree += [_tree_entry(("dense",)), _tree_entry(("dense_opt", "accum"))]
    tree.append(_tree_entry(("step",), write_shape=chunk[("step",)]))
    meta = {"tree_metadata": dict(tree), "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump(meta, f)
    os.makedirs(os.path.join(root, "array_metadatas"), exist_ok=True)
    with open(os.path.join(root, "array_metadatas", "process_0"), "w") as f:
        json.dump({"array_metadatas": [
            {"array_metadata": {"param_name": ".".join(keys), "write_shape": list(c),
                                "chunk_shape": list(c), "ext_metadata": None}}
            for keys, _, c in arrays]}, f)
    now = time.time_ns()
    with open(os.path.join(root, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now, "commit_timestamp_nsecs": now,
                   "custom_metadata": {}}, f)


def _write_process_db(root: str, process: int, shard: RowShard, dense_names, chunk_bytes,
                      timings, staging) -> tuple[int, list]:
    """This process's database: its chunk of the table and the accumulator
    and, on process 0, every ``.zarray``, the dense leaves and the step.
    Returns (bytes, every array's (tree keys, global shape, chunk shape))."""
    st = shard.state
    if st.layout != "rows":
        raise ValueError(f"an orbax save writes the logical arrays; unpack the {st.layout} "
                         "state first (trainer.unpack_state)")
    if st.table_accum is None:
        raise ValueError("save_checkpoint needs a training state (table_accum is missing)")
    if len(dense_names) != len(st.dense):
        raise ValueError(f"{len(st.dense)} dense leaves but {len(dense_names)} dense names "
                         "(an orbax save keys each leaf by its name)")
    lead = process == 0
    if lead and not shard.writes_rows:
        raise ValueError("process 0 writes its rows of the table (and the metadata)")
    rows = max(st.table.shape[0], 1)
    if shard.total % rows or shard.offset % rows:
        raise ValueError(f"rows [{shard.offset}, {shard.offset + rows}) are not one chunk of "
                         f"a {shard.total}-row table")
    sharded = [(("table",), st.table), (("table_opt", "accum"), st.table_accum)]
    whole = [(("dense", n), p) for n, p in zip(dense_names, st.dense)]
    whole += [(("dense_opt", "accum", n), a) for n, a in zip(dense_names, st.dense_accum)]
    whole.append((("step",), np.asarray(st.step, np.int32)))  # the JAX TrainState's dtype
    arrays = [(k, (shard.total,) + tuple(a.shape[1:]), tuple(a.shape)) for k, a in sharded]
    arrays += [(k, tuple(a.shape), tuple(a.shape)) for k, a in whole]
    if not shard.writes_rows:
        return 0, arrays
    db = OcdbtWriter(_process_db(root, process))
    total = 0
    try:
        parts = [(k, a, shard.offset // rows) for k, a in sharded]
        parts += [(k, a, 0) for k, a in whole] if lead else []
        for (keys, arr, index), (_, shape, chunks) in zip(parts, arrays):
            total += _put_array(db, ".".join(keys), arr, chunk_bytes, timings, staging,
                                index=index, shape=shape if lead else None, chunks=chunks)
        total += db.commit()
    except BaseException:
        db.abort()
        raise
    return total, arrays


def _write_sidecars(path: str, step: int, cursor: dict | None) -> None:
    """``<dir>.TRAIN_STEP`` (``latest_step`` without opening the tree) and
    ``<dir>.INPUT_CURSOR``; a save without a cursor removes a stale one."""
    with open(path + "." + _STEP_SIDECAR, "w") as f:
        f.write(str(int(step)))
    sidecar = path + "." + _CURSOR_SIDECAR
    if cursor is None:
        with contextlib.suppress(OSError):
            os.remove(sidecar)
        return
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cursor, f, sort_keys=True)
    os.replace(tmp, sidecar)


def _save_orbax(path: str, state, *, chunk_bytes, cursor, timings, staging, dense_names,
                runtime) -> int:
    """The orbax save.  Every process of an active ``runtime`` calls it at
    the same boundary with its ``RowShard``: process 0 clears
    ``<path>.orbax-checkpoint-tmp``; after a barrier each process writes
    its database there; once every process reports its write, process 0
    writes the root database and the metadata, removes the old directory,
    renames the new one into place and writes the sidecars; its outcome
    reaches every process, and any failure raises on every process."""
    active = runtime is not None and runtime.active
    process = runtime.process_index if active else 0
    shard = state if isinstance(state, RowShard) else RowShard(state, 0, state.table.shape[0])
    tmp = path + _TMP_SUFFIX
    if process == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if active:
        runtime.barrier("orbax-open")
    nbytes, err = 0, None
    arrays = []
    try:
        nbytes, arrays = _write_process_db(tmp, process, shard, dense_names, chunk_bytes,
                                           timings, staging)
    # analysis: ok exception-hygiene a collective save: every process must learn of one failure before any raises
    except Exception as e:
        if not active:
            raise
        err = f"process {process}: {e!r}"
    errors = [e for e in (runtime.allgather("orbax-written", err) if active else [err]) if e]
    outcome = None
    if process == 0 and not errors:
        try:
            t0 = time.perf_counter()
            parts = sorted((p for p in os.listdir(tmp) if p.startswith("ocdbt.process_")),
                           key=lambda p: int(p.rsplit("_", 1)[1]))
            nbytes += write_root(tmp, parts)
            _metadata_files(tmp, arrays, dense_names)
            shutil.rmtree(path, ignore_errors=True)
            # The kill_publish@K injection point: a crash here leaves the new
            # directory unpublished and no directory at ``path``.
            maybe_publish_fault(path)
            os.rename(tmp, path)
            _write_sidecars(path, shard.state.step, cursor)
            if timings is not None:
                timings["write_ms"] = timings.get("write_ms", 0.0) + (
                    time.perf_counter() - t0) * 1e3
        # analysis: ok exception-hygiene the finalize's outcome is broadcast before it raises, so no peer waits out its timeout
        except Exception as e:
            if not active:
                raise
            outcome = f"process 0 finalize: {e!r}"
    if active:
        outcome = runtime.broadcast("orbax-published", "; ".join(errors) or outcome)
    elif errors:
        outcome = "; ".join(errors)
    if outcome:
        raise RuntimeError(f"orbax save of {path!r} failed: {outcome} (the previous "
                           "checkpoint, if any, is unchanged)")
    return nbytes


class _OrbaxDir:
    """An orbax directory opened for reading: its OCDBT tree and
    ``_METADATA``'s tree keys."""

    def __init__(self, path: str):
        self.path = path
        try:
            with open(os.path.join(path, "_METADATA")) as f:
                meta = json.load(f)
        except FileNotFoundError as e:
            raise ValueError(f"{path!r} is not an orbax checkpoint directory (no _METADATA; "
                             "a directory caught mid-write?)") from e
        except ValueError as e:
            raise ValueError(f"{path!r}: _METADATA is not JSON ({e})") from e
        if meta.get("use_zarr3"):
            raise ValueError(f"{path!r} holds zarr v3 arrays (use_zarr3); only zarr v2 "
                             "orbax checkpoints are supported")
        if not meta.get("use_ocdbt", False):
            raise ValueError(f"{path!r} is not an OCDBT orbax checkpoint (use_ocdbt false)")
        self.tree = [tuple(k["key"] for k in v["key_metadata"])
                     for v in meta.get("tree_metadata", {}).values()]
        self.store = OcdbtStore(path)

    def array(self, keys: tuple) -> ZarrArray:
        return ZarrArray(self.store, ".".join(keys))

    def dense_names(self, n_dense: int) -> list[str]:
        """The dense leaves' names in ``jax.tree.flatten`` order (sorted)."""
        names = sorted(k[1] for k in self.tree if len(k) == 2 and k[0] == "dense")
        if len(names) != n_dense:
            raise ValueError(f"orbax checkpoint {self.path!r} holds {len(names)} dense leaves "
                             f"({names}); this model has {n_dense}")
        return names


def orbax_table_shape(path: str) -> tuple:
    """The saved table's global shape, from its ``.zarray`` alone."""
    return _OrbaxDir(path.rstrip("/")).array(("table",)).shape


def _orbax_arrays(path: str, n_dense: int, accum_width: int | None,
                  rows: tuple[int, int] | None = None) -> tuple[dict, _OrbaxDir]:
    """The arrays of the orbax directory ``path`` (the table and
    accumulator rows ``[lo, hi)`` only, given ``rows``).  The mode check
    comes from metadata, before any data is read."""
    d = _OrbaxDir(path)
    if accum_width is not None:
        saved = d.array(("table_opt", "accum")).shape[-1]
        if saved != accum_width:
            raise _accum_mode_error(path, saved, accum_width)
    names = d.dense_names(n_dense)
    out = {"table": d.array(("table",)).read(rows),
           "dense_leaves": [d.array(("dense", n)).read() for n in names],
           "step": d.array(("step",)).read()}
    if accum_width is not None:
        out["table_accum"] = d.array(("table_opt", "accum")).read(rows)
        out["dense_accum"] = [d.array(("dense_opt", "accum", n)).read() for n in names]
    for key in ("table", "table_accum"):
        if key in out and out[key].dtype != np.float32:
            raise ValueError(f"orbax checkpoint {path!r}: {key} is {out[key].dtype}, "
                             "expected float32")
    return out, d


def restore_rows(path: str, device, lo: int, hi: int, *, n_dense: int = 0,
                 accum_width: int | None = None, stats: dict | None = None) -> TrainState:
    """Rows ``[lo, hi)`` of the orbax checkpoint ``path``'s table (and
    accumulator, given ``accum_width``) with its dense leaves and step, as
    a TrainState on ``device``: a rank's shard, reading only the chunks
    that overlap it.  ``stats`` receives ``chunks_read`` and
    ``data_files`` (what the read opened)."""
    path = path.rstrip("/")
    arrays, d = _orbax_arrays(path, n_dense, accum_width, rows=(lo, hi))
    if stats is not None:
        stats["chunks_read"] = sorted(k for k in d.store.values_read
                                      if not k.endswith("/.zarray"))
        stats["data_files"] = sorted(d.store.opened_files)
    return from_jax_arrays(
        arrays["table"], arrays["dense_leaves"], arrays["step"], device,
        table_accum=arrays.get("table_accum"), dense_accum=arrays.get("dense_accum"),
    )


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------


def _accum_mode_error(path: str, saved_width: int, want_width: int) -> ValueError:
    """Accumulator granularity is part of the optimizer's identity (the
    JAX package's message, word for word)."""
    if saved_width > 1 and want_width > 1:
        return ValueError(
            f"checkpoint {path!r} has accumulator rows of width {saved_width} "
            f"but this config expects width {want_width} — the model's row "
            "width changed (factor_num / model type); restore with the "
            "configuration the checkpoint was trained under"
        )
    mode = lambda d: "row" if d == 1 else "element"  # noqa: E731
    return ValueError(
        f"checkpoint {path!r} was trained with adagrad_accumulator = "
        f"{mode(saved_width)} (accum width {saved_width}) "
        f"but this config expects {mode(want_width)} "
        f"(width {want_width}); set adagrad_accumulator "
        "to match the checkpoint"
    )


def _npz_string(z, key) -> str | None:
    if key not in getattr(z, "files", ()):
        return None
    return bytes(np.asarray(z[key]).tobytes()).decode()


def _load_npz(path: str, n_dense: int, with_accum: bool) -> dict:
    """The members as host arrays; the accumulators only ``with_accum``."""
    with _open_npz(path) as z:
        if "tier_hot_ids" in getattr(z, "files", ()):
            # Its ``table`` member is only the hot tier: loading it as the full
            # table would score or train on a sliver of the model.
            raise ValueError(
                f"{path!r} is a TIERED parameter-store checkpoint (its "
                "'table' member holds only the device-resident hot rows; "
                "the cold tier lives in the run's .store directory) — "
                "resume it with [ParamStore] enabled; predict/serve need "
                "a resident export"
            )
        try:
            out = {
                "table": z["table"],
                "dense_leaves": [z[f"dense_{i}"] for i in range(n_dense)],
                "step": z["step"],
            }
            accum_names = ["table_accum", *(f"dense_accum_{i}" for i in range(n_dense))]
            if with_accum:
                out["table_accum"] = z["table_accum"]
                out["dense_accum"] = [z[f"dense_accum_{i}"] for i in range(n_dense)]
            else:
                # A scoring restore still reads the accumulators through
                # their CRC, as the JAX restore (which loads them) does: a
                # file torn only there is a torn publish, refused whole.
                for name in (n for n in accum_names if n in z.files):
                    with z.zip.open(f"{name}.npy") as member:
                        while member.read(DEFAULT_CHUNK_BYTES):
                            pass
            return out
        except (KeyError, zipfile.BadZipFile, ValueError, EOFError) as e:
            raise _torn_error(path, "missing or unreadable member", e) from e


# ---------------------------------------------------------------------------
# delta chain
# ---------------------------------------------------------------------------


def _delta_path(path: str, seq: int) -> str:
    return f"{path}.delta-{seq:04d}.npz"


def save_delta(
    path: str,
    seq: int,
    *,
    idx: np.ndarray,
    table_rows,
    accum_rows,
    dense_leaves,
    dense_accum_leaves,
    step,
    parent_sig: str,
    save_id: str | None = None,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    timings: dict | None = None,
    cursor: dict | None = None,
    staging=None,
) -> tuple[str, str, int]:
    """Atomically write delta file ``seq`` of base ``path`` (the JAX
    ``save_delta``'s members): the logical rows ``idx`` and their table and
    accumulator rows, every dense leaf, the step, the chain link and the
    optional cursor, so the chain head names the input position of the
    state it restores to.  Returns (delta_path, save_id, bytes_written)."""
    sid = save_id or uuid.uuid4().hex
    entries = {
        "delta_idx": np.asarray(idx, np.int64),
        "table_rows": table_rows,
        "accum_rows": accum_rows,
        "step": np.asarray(step, np.int32),
        "parent_sig": np.frombuffer(parent_sig.encode(), np.uint8),
        "save_id": np.frombuffer(sid.encode(), np.uint8),
        "published_at": np.asarray(time.time(), np.float64),
    }
    if cursor is not None:
        entries["input_cursor"] = _cursor_entry(cursor)
    for i, (p, a) in enumerate(zip(dense_leaves, dense_accum_leaves, strict=True)):
        entries[f"dense_{i}"] = p
        entries[f"dense_accum_{i}"] = a
    out = _delta_path(path, seq)
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        nbytes = _write_npz_streaming(f, entries, chunk_bytes, timings, staging)
    maybe_publish_fault(out)
    os.replace(tmp, out)
    return out, sid, nbytes


def load_delta(dp: str, n_dense: int) -> dict:
    """One delta file's payload (host arrays).  A torn or truncated file
    raises a ValueError naming it."""
    with _open_npz(dp) as z:
        try:
            return {
                "idx": np.asarray(z["delta_idx"]),
                "table_rows": np.asarray(z["table_rows"]),
                "accum_rows": np.asarray(z["accum_rows"]),
                "dense": [np.asarray(z[f"dense_{i}"]) for i in range(n_dense)],
                "dense_accum": [np.asarray(z[f"dense_accum_{i}"]) for i in range(n_dense)],
                "step": np.asarray(z["step"]),
                "parent_sig": _npz_string(z, "parent_sig"),
                "save_id": _npz_string(z, "save_id"),
            }
        except (KeyError, zipfile.BadZipFile, ValueError, EOFError) as e:
            raise _torn_error(dp, "missing or unreadable member", e) from e


def read_delta_chain(path: str) -> tuple[str | None, list[dict]]:
    """(base save_id, chain metadata) of ``path``'s delta files — metadata
    only (path, sigs, step, rows).  A delta whose ``parent_sig`` breaks the
    chain raises the JAX package's ValueError naming the file (full saves
    unlink the chain before they publish, so a broken link is corruption)."""
    base_sig = checkpoint_save_id(path)
    chain: list[dict] = []
    expect = base_sig
    for dp in delta_paths(path):
        with _open_npz(dp) as z:
            try:
                meta = {
                    "path": dp,
                    "parent_sig": _npz_string(z, "parent_sig"),
                    "save_id": _npz_string(z, "save_id"),
                    "step": int(z["step"]),
                    "rows": int(z["delta_idx"].shape[0]),
                }
            except (KeyError, zipfile.BadZipFile, ValueError, EOFError) as e:
                raise _torn_error(dp, "missing or unreadable member", e) from e
        if expect is None or meta["parent_sig"] != expect:
            raise ValueError(
                f"delta checkpoint {dp!r} does not chain from "
                f"{'the base ' + path if not chain else chain[-1]['path']!r} "
                f"(parent_sig {meta['parent_sig']!r} != expected {expect!r}) — "
                "stale or corrupt delta; delete the delta files or re-save a "
                "full checkpoint"
            )
        chain.append(meta)
        expect = meta["save_id"]
    return base_sig, chain


def checkpoint_save_id(path: str) -> str | None:
    """Content identity of a full npz checkpoint (None for a file without
    one, a missing file or a directory)."""
    path = path.rstrip("/")
    if not os.path.isfile(path):
        return None
    try:
        with _open_npz(path) as z:
            return _npz_string(z, "save_id")
    except ValueError:
        return None


def read_publish_time(path: str) -> float | None:
    """Publish time (wall clock, seconds) of ``path``'s chain head: the
    newest delta when delta files extend the base, else the base.  None
    for a file without the member, a missing file or anything unreadable."""
    path = path.rstrip("/")
    if not os.path.isfile(path):
        return None
    deltas = delta_paths(path)
    head = deltas[-1] if deltas else path
    try:
        with _open_npz(head) as z:
            if "published_at" not in getattr(z, "files", ()):
                return None
            return float(z["published_at"])
    except (ValueError, OSError):
        return None


def restore_checkpoint(
    path: str, device, *, n_dense: int = 0, accum_width: int | None = None
) -> TrainState:
    """Load the checkpoint at ``path`` onto ``device`` (a torch.device): an
    npz file with its delta chain replayed when delta files extend it
    (content-signature checked, in order: the state returned is the chain
    head's), or an orbax directory.

    ``accum_width`` None restores the parameters only (scoring).  A width
    (``D`` for element, 1 for row) restores the Adagrad accumulators too,
    for training, and refuses a checkpoint (or a delta) of the other
    granularity."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        # An orbax directory has no delta chain (config refuses deltas with it).
        arrays, _ = _orbax_arrays(path, n_dense, accum_width)
        return from_jax_arrays(
            arrays["table"], arrays["dense_leaves"], arrays["step"], device,
            table_accum=arrays.get("table_accum"), dense_accum=arrays.get("dense_accum"),
        )
    chain = read_delta_chain(path)[1] if delta_paths(path) else []
    arrays = _load_npz(path, n_dense, with_accum=accum_width is not None)
    if accum_width is not None:
        saved = arrays["table_accum"].shape[-1]
        if saved != accum_width:
            raise _accum_mode_error(path, saved, accum_width)
    if chain:
        # Writable copies: np.load's arrays may be read-only views.
        arrays["table"] = np.array(arrays["table"])
        if accum_width is not None:
            arrays["table_accum"] = np.array(arrays["table_accum"])
    for meta in chain:
        delta = load_delta(meta["path"], n_dense)
        idx = delta["idx"]
        keep = idx < arrays["table"].shape[0]
        arrays["table"][idx[keep]] = delta["table_rows"][keep]
        if accum_width is not None:
            rows = delta["accum_rows"]
            if rows.size and rows.shape[-1] != accum_width:
                # Before the scatter: the actionable mode error, not a raw
                # broadcast failure.
                raise _accum_mode_error(meta["path"], rows.shape[-1], accum_width)
            arrays["table_accum"][idx[keep]] = rows[keep]
            arrays["dense_accum"] = delta["dense_accum"]
        arrays["dense_leaves"] = delta["dense"]
        arrays["step"] = delta["step"]
    return from_jax_arrays(
        arrays["table"], arrays["dense_leaves"], arrays["step"], device,
        table_accum=arrays.get("table_accum"), dense_accum=arrays.get("dense_accum"),
    )


def read_input_cursor(path: str) -> dict | None:
    """The ``input_cursor`` of the checkpoint at ``path`` (of its delta
    chain's head when delta files extend it), or None when the file, the
    member or a readable dict is absent: a pre-cursor checkpoint resumes
    from the first file, never an error.  An orbax directory's cursor is
    its ``INPUT_CURSOR`` sidecar."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        try:
            with open(path + "." + _CURSOR_SIDECAR) as f:
                out = json.load(f)
            return out if isinstance(out, dict) else None
        except (OSError, ValueError):
            return None
    if not os.path.isfile(path):
        return None
    deltas = delta_paths(path)
    head = deltas[-1] if deltas else path
    try:
        with _open_npz(head) as z:
            if "input_cursor" not in getattr(z, "files", ()):
                return None
            out = json.loads(bytes(np.asarray(z["input_cursor"]).tobytes()).decode())
        return out if isinstance(out, dict) else None
    except (ValueError, OSError):  # json.JSONDecodeError is a ValueError
        return None


def latest_step(path: str) -> int | None:
    """Step stored in a checkpoint (the delta chain head's when deltas extend
    it; an orbax directory's ``TRAIN_STEP`` sidecar), or None if absent or
    unreadable."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        try:
            with open(path + "." + _STEP_SIDECAR) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None
    if not os.path.isfile(path):
        return None
    deltas = delta_paths(path)
    head = deltas[-1] if deltas else path
    try:
        with np.load(head) as z:
            return int(z["step"])
    except (OSError, ValueError, KeyError, zipfile.BadZipFile, EOFError):
        return None


def checkpoint_signature(path: str) -> tuple | None:
    """Cheap change detector: (step, mtime_ns, size) of the checkpoint plus
    (name, mtime_ns, size) of each delta file, or None when absent or
    unreadable — the tuple ``fast_tffm_tpu/checkpoint.py`` gives, which the
    serving watcher polls.  An orbax directory's is its sidecar step and
    the directory's own stat (a rename puts a new inode in place); one can
    be observed mid-write, so the watcher treats a failed restore as retry
    next tick."""
    path = path.rstrip("/")
    step = latest_step(path)
    if step is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    sig = [step, st.st_mtime_ns, st.st_size]
    for dp in delta_paths(path):
        try:
            dst = os.stat(dp)
        except OSError:
            continue
        sig.append((os.path.basename(dp), dst.st_mtime_ns, dst.st_size))
    return tuple(sig)
