"""Bring the JAX package's parameters into the port.

Both packages persist the same logical arrays (``checkpoint.py``'s npz
members).  ``from_jax_arrays`` takes them as numpy arrays — from an npz
restore, or from a JAX ``TrainState`` converted with ``np.asarray`` in a
test — and places them on the port's device as a ``TrainState``: the
table, the dense leaves and the step, plus the Adagrad accumulators when
given, so a JAX training state carries across whole.  A JAX packed or
fused state (``trainer.pack_state``: a [VP, 128] or [VPf, 128] table) keeps
its physical layout, which the port shares bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_tffm_tpu_torch.ops.packed_table import LANES
from fast_tffm_tpu_torch.trainer import LAYOUTS, TrainState

__all__ = ["from_jax_arrays"]


def _tensor(arr, device: torch.device) -> torch.Tensor:
    # A read-only buffer (a JAX array's) is copied: training updates in place.
    host = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if device.type == "cuda":
        host = host.pin_memory()  # one DMA at full rate instead of a staged copy
    return host.to(device)


def from_jax_arrays(
    table, dense_leaves, step, device, *, table_accum=None, dense_accum=None, layout="rows"
) -> TrainState:
    """``table`` [V, D], ``dense_leaves`` in ``jax.tree.flatten`` order and
    ``step`` → a TrainState on ``device`` (a ``torch.device``).
    ``table_accum`` ([V, D] or [V, 1]) and ``dense_accum`` (one per dense
    leaf) are the JAX state's ``table_opt.accum`` and flattened
    ``dense_opt.accum``; without them the state is for scoring only.

    ``layout`` ``packed`` or ``fused`` takes a JAX packed state's [VP, 128]
    or fused state's [VPf, 128] table as it is; a fused state's accumulator
    lives in its table, and the JAX marker (an empty [0, 1]
    ``table_accum``) may be passed or left out."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} ({' | '.join(LAYOUTS)})")
    table = np.asarray(table)
    if table.ndim != 2 or table.dtype != np.float32:
        raise ValueError(f"table must be a [V, D] float32 array, got {table.shape} {table.dtype}")
    if layout != "rows" and table.shape[1] != LANES:
        raise ValueError(f"a {layout} table is [rows, {LANES}], got {table.shape}")
    if layout == "fused" and table_accum is not None:
        if np.asarray(table_accum).size:
            raise ValueError("a fused state's accumulator lives in its table; got a "
                             f"{np.asarray(table_accum).shape} table_accum")
        table_accum = None
    if layout == "packed" and table_accum is not None:
        raise ValueError("a packed state is taken for scoring, without table_accum")
    accum = None
    if table_accum is not None:
        table_accum = np.asarray(table_accum)
        if (
            table_accum.dtype != np.float32
            or table_accum.shape[0] != table.shape[0]
            or table_accum.shape[1:] not in ((1,), (table.shape[1],))
        ):
            raise ValueError(
                f"table_accum must be a [V, 1] or [V, D] float32 array for a "
                f"{table.shape} table, got {table_accum.shape} {table_accum.dtype}"
            )
        accum = _tensor(table_accum, device)
    dense_accum = [] if dense_accum is None else list(dense_accum)
    if dense_accum and len(dense_accum) != len(dense_leaves):
        raise ValueError(
            f"{len(dense_accum)} dense accumulators for {len(dense_leaves)} dense leaves"
        )
    return TrainState(
        table=_tensor(table, device),
        dense=[_tensor(np.asarray(x), device) for x in dense_leaves],
        step=int(np.asarray(step)),
        table_accum=accum,
        dense_accum=[_tensor(np.asarray(x), device) for x in dense_accum],
        layout=layout,
    )
