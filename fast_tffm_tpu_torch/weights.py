"""Bring the JAX package's parameters into the port.

Both packages persist the same logical arrays (``checkpoint.py``'s npz
members).  ``from_jax_arrays`` takes them as numpy arrays — from an npz
restore, or from a JAX state converted with ``np.asarray`` in a test — and
places them on the port's device as a ``TrainState``.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_tffm_tpu_torch.trainer import TrainState

__all__ = ["from_jax_arrays"]


def _tensor(arr, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        host = host.pin_memory()  # one DMA at full rate instead of a staged copy
    return host.to(device)


def from_jax_arrays(table, dense_leaves, step, device) -> TrainState:
    """``table`` [V, D], ``dense_leaves`` in ``jax.tree.flatten`` order and
    ``step`` → a TrainState on ``device`` (a ``torch.device``)."""
    table = np.asarray(table)
    if table.ndim != 2 or table.dtype != np.float32:
        raise ValueError(f"table must be a [V, D] float32 array, got {table.shape} {table.dtype}")
    return TrainState(
        table=_tensor(table, device),
        dense=[_tensor(np.asarray(x), device) for x in dense_leaves],
        step=int(np.asarray(step)),
    )
