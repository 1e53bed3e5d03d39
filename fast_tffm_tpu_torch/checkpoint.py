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
``table`` is only the hot tier), an orbax directory, a checkpoint
extended by a delta chain (replaying deltas is a later slice; the base
alone would be stale rows), and for training an accumulator of the wrong
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


def _array_row_chunks(arr, chunk_bytes: int):
    """C-contiguous host chunks of ``arr`` (a tensor on any device, or a
    numpy value), never staging more than ~chunk_bytes on the host at once:
    the per-chunk copy is where the device→host transfer happens."""
    shape = tuple(arr.shape)
    if not shape:
        yield np.ascontiguousarray(_host(arr))
        return
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize
    row_bytes = itemsize * int(np.prod(shape[1:], dtype=np.int64) or 1)
    rows = max(1, chunk_bytes // max(1, row_bytes))
    for lo in range(0, shape[0], rows):
        yield np.ascontiguousarray(_host(arr[lo : lo + rows]))


def _np_dtype(arr) -> np.dtype:
    if isinstance(arr, torch.Tensor):
        return torch.empty((), dtype=arr.dtype).numpy().dtype
    return arr.dtype


def _write_npz_streaming(fileobj, entries: dict, chunk_bytes: int) -> int:
    """Write a np.load-compatible npz (ZIP_STORED) from ``entries`` (name →
    tensor or numpy value), streaming each array in bounded chunks.
    Returns the payload bytes."""
    total = 0
    with zipfile.ZipFile(fileobj, "w", zipfile.ZIP_STORED) as zf:
        for name, arr in entries.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as member:
                member.write(_npy_header_bytes(arr.shape, _np_dtype(arr)))
                for chunk in _array_row_chunks(arr, chunk_bytes):
                    member.write(chunk)
                    total += chunk.nbytes
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
) -> int:
    """Atomic full npz save of a training state; returns payload bytes.

    The members are ``_save_npz``'s; ``cursor`` (``training.train``'s
    input position: epoch, batch in epoch, the input's identity) becomes
    the ``input_cursor`` member, and a save without one writes the
    pre-cursor layout, which both packages resume from the first file."""
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
        nbytes = _write_npz_streaming(f, entries, chunk_bytes)
    # Reset the delta chain BEFORE the publish: a crash between the two
    # leaves the old base alone, still a complete checkpoint.
    for dp in delta_paths(path):
        try:
            os.remove(dp)
        except OSError:
            pass
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


def restore_checkpoint(
    path: str, device, *, n_dense: int = 0, accum_width: int | None = None
) -> TrainState:
    """Load the npz checkpoint at ``path`` onto ``device`` (a torch.device).

    ``accum_width`` None restores the parameters only (scoring).  A width
    (``D`` for element, 1 for row) restores the Adagrad accumulators too,
    for training, and refuses a checkpoint of the other granularity."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        raise ValueError(
            f"{path!r} is an orbax checkpoint directory — orbax restore is not "
            "ported yet (a later slice of fast_tffm_tpu_torch); export an npz"
        )
    deltas = delta_paths(path)
    if deltas:
        raise ValueError(
            f"{path!r} is extended by {len(deltas)} delta file(s) — replaying a "
            "delta chain is not ported yet (a later slice of fast_tffm_tpu_torch), "
            "and the base alone would hold stale rows"
        )
    arrays = _load_npz(path, n_dense, with_accum=accum_width is not None)
    if accum_width is not None:
        saved = arrays["table_accum"].shape[-1]
        if saved != accum_width:
            raise _accum_mode_error(path, saved, accum_width)
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
