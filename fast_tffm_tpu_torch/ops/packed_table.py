"""Lane-packed tables — the part of ``fast_tffm_tpu/ops/packed_table.py``
that the fused training path and packed scoring read.

The physical layouts are the JAX package's, bit for bit, so a packed or
fused state carries across unchanged:

* **packed** (``table_layout = packed``, scoring): ``[VP, 128]`` float32,
  ``P = 128 // D`` logical rows per 128-lane tile row, row ``i`` at tile
  row ``i // P``, lanes ``[(i % P)·D, (i % P)·D + D)``; spare lanes and
  the pad rows of the last tile row hold ``pad_value``.
* **fused** (``adagrad_accumulator = fused``, training): ``[VPf, 128]``,
  ``P = 128 // (D + 1)`` slots per tile row; slot ``s`` holds its D
  parameters at lanes ``[s·(D+1), s·(D+1)+D)`` and its row accumulator
  at lane ``s·(D+1)+D``.  Pad slots carry 0 in the parameter lanes and
  ``init_value`` in the accumulator lane, and the tail lanes
  ``P·(D+1)..127`` carry ``init_value``: no accumulator lane is ever 0.

Checkpoints hold the logical arrays (``unpack_*``).  The gathers are one
advanced index into a ``[VP, P, D]`` (or ``[VPf, P, D+1]``) view of the
used lanes; the JAX package's P-way masked-slice loop is a TPU lane idiom.
A pack fills one preallocated tensor (no chunked donation, which is an XLA
memory device); an unpack is one copy of the used lanes.
"""

from __future__ import annotations

import torch

__all__ = [
    "LANES",
    "rows_per_tile",
    "packed_rows",
    "pack_table",
    "unpack_table",
    "packed_gather",
    "fused_rows_per_tile",
    "fused_packed_rows",
    "fused_slots",
    "pack_fused",
    "unpack_fused",
    "fused_gather",
]

LANES = 128


def rows_per_tile(d: int) -> int:
    """Logical rows per 128-lane tile row of the packed layout; 64 < D <= 128
    gives P = 1 (one padded row per tile row)."""
    if d > LANES:
        raise ValueError(f"packed layout needs D <= {LANES}, got {d}")
    return max(1, LANES // d)


def packed_rows(vocab: int, d: int) -> int:
    return -(-vocab // rows_per_tile(d))


def _slots(packed: torch.Tensor, p: int, width: int) -> torch.Tensor:
    """The ``[VP, P, width]`` view of the used lanes of ``[VP, 128]``."""
    return packed[:, : p * width].view(packed.shape[0], p, width)


def _fill(out: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Write ``flat`` [VP·P, width] into the used lanes of ``out`` [VP, 128]."""
    out[:, : flat.numel() // out.shape[0]] = flat.view(out.shape[0], -1)
    return out


def pack_table(table: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """[V, D] logical -> [VP, 128] packed (pad lanes and rows = pad_value),
    on the table's device."""
    v, d = table.shape
    p = rows_per_tile(d)
    vp = packed_rows(v, d)
    kw = dict(dtype=table.dtype, device=table.device)
    flat = torch.full((vp * p, d), pad_value, **kw)
    flat[:v] = table
    return _fill(torch.full((vp, LANES), pad_value, **kw), flat)


def unpack_table(packed: torch.Tensor, vocab: int, d: int) -> torch.Tensor:
    """[VP, 128] packed -> [V, D] logical (a copy)."""
    return _slots(packed, rows_per_tile(d), d).reshape(-1, d)[:vocab]


def packed_gather(packed: torch.Tensor, ids: torch.Tensor, d: int) -> torch.Tensor:
    """rows[..., D] for logical ``ids`` from a packed table."""
    p = rows_per_tile(d)
    ids = ids.long()
    return _slots(packed, p, d)[ids // p, ids % p]


def fused_rows_per_tile(d: int) -> int:
    """Slots per 128-lane row in the fused layout: P = 128 // (D + 1)."""
    if d + 1 > LANES:
        raise ValueError(f"fused layout needs D + 1 <= {LANES}, got D={d}")
    return LANES // (d + 1)


def fused_packed_rows(vocab: int, d: int) -> int:
    return -(-vocab // fused_rows_per_tile(d))


def fused_slots(fused: torch.Tensor, d: int) -> torch.Tensor:
    """The ``[VPf, P, D+1]`` view of a fused array's slots (lane D of a
    slot is its accumulator); writes through it update ``fused``."""
    return _slots(fused, fused_rows_per_tile(d), d + 1)


def pack_fused(table: torch.Tensor, accum: torch.Tensor, init_value: float) -> torch.Tensor:
    """[V, D] table + [V, 1] row accumulator -> [VPf, 128] fused rows, on
    the table's device."""
    if accum.dim() != 2 or accum.shape[-1] != 1:
        raise ValueError(f"fused layout packs a ROW accumulator [V, 1], got {tuple(accum.shape)}")
    v, d = table.shape
    p = fused_rows_per_tile(d)
    vp = fused_packed_rows(v, d)
    kw = dict(dtype=table.dtype, device=table.device)
    flat = torch.zeros((vp * p, d + 1), **kw)  # pad slots: zero parameters,
    flat[:, d] = init_value  # init_value accumulators
    flat[:v, :d] = table
    flat[:v, d:] = accum
    return _fill(torch.full((vp, LANES), init_value, **kw), flat)


def unpack_fused(fused: torch.Tensor, vocab: int, d: int):
    """[VPf, 128] fused -> ([V, D] table, [V, 1] accumulator): views of one
    copy of the used lanes."""
    flat = fused_slots(fused, d).reshape(-1, d + 1)[:vocab]
    return flat[:, :d], flat[:, d:]


def fused_gather(fused: torch.Tensor, ids: torch.Tensor, d: int) -> torch.Tensor:
    """rows[..., D] for logical ``ids`` from a fused table (accumulator
    lanes skipped)."""
    p = fused_rows_per_tile(d)
    ids = ids.long()
    return fused_slots(fused, d)[ids // p, ids % p, :d]
