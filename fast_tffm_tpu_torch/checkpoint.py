"""npz checkpoint restore — the serving half of ``fast_tffm_tpu/checkpoint.py``.

Reads the single-file npz that ``fast_tffm_tpu/checkpoint.py::_save_npz``
writes: members ``table`` [V, D], ``step`` and ``dense_{i}`` (plus
``table_accum``, ``dense_accum_{i}``, ``save_id``, ``published_at`` and an
optional ``input_cursor``, which serving does not need).  Only the
parameters are read: scoring never touches the Adagrad accumulators, so
``table_accum`` stays on disk (the training slice restores it).

Refused rather than misread: a tiered parameter-store checkpoint (its
``table`` is only the hot tier), an orbax directory, and a checkpoint
extended by a delta chain (replaying deltas is a later slice; the base
alone would serve stale rows).
"""

from __future__ import annotations

import glob
import os
import re
import zipfile

import numpy as np

from fast_tffm_tpu_torch.trainer import TrainState
from fast_tffm_tpu_torch.weights import from_jax_arrays

__all__ = ["restore_checkpoint", "checkpoint_signature", "latest_step", "delta_paths"]

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


def _load_npz(path: str, n_dense: int):
    """(table, dense leaves, step) as host arrays."""
    with _open_npz(path) as z:
        if "tier_hot_ids" in getattr(z, "files", ()):
            raise ValueError(
                f"{path!r} is a TIERED parameter-store checkpoint (its 'table' "
                "member holds only the device-resident hot rows) — serving needs "
                "a resident export"
            )
        try:
            return (
                z["table"],
                [z[f"dense_{i}"] for i in range(n_dense)],
                z["step"],
            )
        except (KeyError, zipfile.BadZipFile, ValueError, EOFError) as e:
            raise _torn_error(path, "missing or unreadable member", e) from e


def restore_checkpoint(path: str, device, *, n_dense: int = 0) -> TrainState:
    """Load the npz checkpoint at ``path`` onto ``device`` (a torch.device)."""
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
            "and the base alone would serve stale rows"
        )
    table, dense, step = _load_npz(path, n_dense)
    return from_jax_arrays(table, dense, step, device)


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
