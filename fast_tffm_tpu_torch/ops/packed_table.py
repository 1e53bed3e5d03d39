"""Lane-packed tables — ``fast_tffm_tpu/ops/packed_table.py``'s layouts,
packers and gathers (its XLA update strategies are one kernel here,
``ops/tail.py``).

The physical layouts are the JAX package's, bit for bit, so a packed or
fused state carries across unchanged:

* **packed** (``table_layout = packed``, scoring): ``[VP, 128]`` float32,
  ``P = 128 // D`` logical rows per 128-lane tile row, row ``i`` at tile
  row ``i // P``, lanes ``[(i % P)·D, (i % P)·D + D)``; spare lanes and
  the pad rows of the last tile row hold ``pad_value``.  Its Adagrad
  accumulator is ``[VP, 128]`` packed the same way (element granularity,
  pads ``init_value``) or ``[VP, P]``, one slot a row (row granularity);
  ``pack_accum_any`` packs either.
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
    "packed_slots",
    "packed_gather",
    "scatter_logical_rows",
    "pack_accum_any",
    "unpack_accum_any",
    "packed_accum_gather_any",
    "fused_rows_per_tile",
    "fused_packed_rows",
    "fused_slots",
    "pack_fused",
    "unpack_fused",
    "fused_gather",
    "fused_accum_gather",
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


def packed_slots(packed: torch.Tensor, d: int) -> torch.Tensor:
    """The ``[VP, P, D]`` view of a packed array's logical rows; writes
    through it update ``packed``."""
    return _slots(packed, rows_per_tile(d), d)


def packed_gather(packed: torch.Tensor, ids: torch.Tensor, d: int) -> torch.Tensor:
    """rows[..., D] for logical ``ids`` from a packed table."""
    p = rows_per_tile(d)
    ids = ids.long()
    return _slots(packed, p, d)[ids // p, ids % p]


def scatter_logical_rows(
    packed: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, d: int
) -> torch.Tensor:
    """A copy of the packed table with logical ``rows`` [M, D] written at
    ``ids`` (the inverse of ``packed_gather``; the JAX function of the same
    name): how the serving reload applies a checkpoint delta without
    re-reading the full table.  Neighbouring rows of a tile row, spare
    lanes and untouched rows keep their values; ids past the last tile row
    are dropped.  Never writes ``packed`` itself: a flush may be reading
    it."""
    p = rows_per_tile(d)
    ids = ids.long().reshape(-1)
    rows = rows.reshape(-1, d)
    keep = ids // p < packed.shape[0]
    ids, rows = ids[keep], rows[keep]
    out = packed.clone()
    _slots(out, p, d)[ids // p, ids % p] = rows.to(out.dtype)
    return out


def pack_accum_any(accum: torch.Tensor, d: int, init_value: float) -> torch.Tensor:
    """Pack a logical accumulator of either granularity; pad lanes, rows and
    slots carry ``init_value``, never 0.  [V, D] element -> [VP, 128],
    packed as the table is; [V, 1] row -> [VP, P], one slot a logical row
    (row r at flat index r)."""
    if accum.shape[-1] != 1:
        return pack_table(accum, pad_value=init_value)
    v = accum.shape[0]
    flat = torch.full((packed_rows(v, d) * rows_per_tile(d),), init_value, dtype=accum.dtype,
                      device=accum.device)
    flat[:v] = accum.reshape(-1)
    return flat.view(-1, rows_per_tile(d))


def unpack_accum_any(acc_packed: torch.Tensor, vocab: int, d: int) -> torch.Tensor:
    """The inverse of ``pack_accum_any`` (a copy): [VP, 128] -> [V, D],
    [VP, P] -> [V, 1].  At D = 1 (P = 128) the two coincide, and so do both
    branches."""
    if acc_packed.shape[-1] == LANES and rows_per_tile(d) != LANES:
        return unpack_table(acc_packed, vocab, d)
    return acc_packed.reshape(-1, 1)[:vocab].clone()


def packed_accum_gather_any(acc_packed: torch.Tensor, ids: torch.Tensor, d: int) -> torch.Tensor:
    """Logical accumulator rows for ``ids`` from a packed accumulator of
    either granularity: [VP, 128] element -> [..., D], [VP, P] row ->
    [..., 1] (the delta writer's twin of ``packed_gather``)."""
    p = rows_per_tile(d)
    if acc_packed.shape[-1] == LANES and p != LANES:
        return packed_gather(acc_packed, ids, d)
    ids = ids.long()
    return acc_packed[ids // p, ids % p][..., None]


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


def fused_accum_gather(fused: torch.Tensor, ids: torch.Tensor, d: int) -> torch.Tensor:
    """[..., 1] row-accumulator values for logical ``ids`` from a fused
    table (each slot's lane D)."""
    p = fused_rows_per_tile(d)
    ids = ids.long()
    return fused_slots(fused, d)[ids // p, ids % p, d:]
