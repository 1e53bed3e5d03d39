"""npz checkpoints — the single-file half of ``fast_tffm_tpu/checkpoint.py``.

Save: ``save_checkpoint`` writes what ``fast_tffm_tpu/checkpoint.py::_save_npz``
writes — members ``table`` [V, D], ``table_accum``, ``step``, ``save_id``,
``published_at``, ``dense_{i}`` / ``dense_accum_{i}`` and, given a
``cursor``, ``input_cursor`` (the exact input position the state stands
at, canonical JSON bytes) — streaming each array device→host in bounded
row chunks into a ZIP_STORED npz, to ``<path>.tmp`` first and then
``os.replace`` onto ``path``, after removing any sibling delta files.
Either package restores what the other saved, cursor included.

Restore: ``restore_checkpoint`` reads the parameters (``table``, ``step``,
``dense_{i}``) for scoring and, given the accumulator width a training
config expects, the Adagrad accumulators too; ``read_input_cursor`` reads
the cursor (None for a checkpoint saved without one).

Both hold the logical arrays whatever layout the run trains in: a fused
run saves ``trainer.unpack_state`` of its state (a [V, D] table and a
[V, 1] accumulator) and packs what it restores, so rows, packed and fused
runs restore each other's checkpoints, as in the JAX package.

Refused rather than misread: a tiered parameter-store checkpoint (its
``table`` is only the hot tier), an orbax directory, a delta that does not
chain from its base, and for training an accumulator of the wrong
granularity.
"""

from __future__ import annotations

import glob
import io
import json
import os
import re
import time
import uuid
import zipfile

import numpy as np
import torch

from fast_tffm_tpu_torch.resilience import maybe_publish_fault
from fast_tffm_tpu_torch.trainer import TrainState
from fast_tffm_tpu_torch.weights import from_jax_arrays

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "read_input_cursor",
    "checkpoint_signature",
    "latest_step",
    "delta_paths",
    "DEFAULT_CHUNK_BYTES",
]

DEFAULT_CHUNK_BYTES = 64 << 20  # host staging bound per array slice
_DELTA_RE = re.compile(r"\.delta-(\d{4})\.npz$")


def _torn_error(path: str, what: str, exc: Exception) -> ValueError:
    return ValueError(
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
    state: TrainState,
    *,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    save_id: str | None = None,
    cursor: dict | None = None,
    timings: dict | None = None,
    staging=None,
) -> int:
    """Atomic full npz save of a training state; returns payload bytes.

    The members are ``_save_npz``'s; ``cursor`` (``training.train``'s
    input position: epoch, batch in epoch, the input's identity) becomes
    the ``input_cursor`` member, and a save without one writes the
    pre-cursor layout, which both packages resume from the first file.
    ``save_id`` is the delta chain's content anchor (fresh when None);
    ``timings`` and ``staging`` as in ``_write_npz_streaming``."""
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
            raise ValueError(
                f"{path!r} is a TIERED parameter-store checkpoint (its 'table' "
                "member holds only the device-resident hot rows) — serving needs "
                "a resident export"
            )
        try:
            out = {
                "table": z["table"],
                "dense_leaves": [z[f"dense_{i}"] for i in range(n_dense)],
                "step": z["step"],
            }
            if with_accum:
                out["table_accum"] = z["table_accum"]
                out["dense_accum"] = [z[f"dense_accum_{i}"] for i in range(n_dense)]
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
    """Load the npz checkpoint at ``path`` onto ``device`` (a torch.device),
    replaying its delta chain when delta files extend it (content-signature
    checked, in order: the state returned is the chain head's).

    ``accum_width`` None restores the parameters only (scoring).  A width
    (``D`` for element, 1 for row) restores the Adagrad accumulators too,
    for training, and refuses a checkpoint (or a delta) of the other
    granularity."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is an orbax checkpoint directory — orbax restore is not "
            "ported yet (a later slice of fast_tffm_tpu_torch); export an npz"
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
    from the first file, never an error."""
    path = path.rstrip("/")
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
    it), or None if absent or unreadable."""
    path = path.rstrip("/")
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
    unreadable — the same tuple ``fast_tffm_tpu/checkpoint.py`` gives for an
    npz file, which the hot-reload slice will poll."""
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
