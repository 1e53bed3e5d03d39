"""Row-sharded embedding lookup and sparse Adagrad update over the mesh of
ranks — the counterpart of ``fast_tffm_tpu/parallel/embedding.py``.

Each rank holds the row shard ``[V_pad / R, D]`` (or its packed or fused
form) and scores its own ``B / P`` slice of the global batch:

  lookup:  the rank all-gathers its row group's ids, serves the rows it
           owns (the others masked to 0) and a reduce-scatter over the row
           group hands each rank its own rows: every row has one owner and
           the others add zeros, so the sum is exact.
  update:  per-occurrence row gradients are deduped locally
           (``dedup_rows_padded``: the JAX ``dedup_rows``, padded to M with
           the sentinel id), all-gathered over the world in rank order, and
           each rank applies Adagrad to the rows it owns: the gathered ids
           are mapped to local ids (unowned ones and sentinels past the
           shard's end) and ONE launch of the rows Adagrad kernel B4
           (``ops/tail.py``) sorts them stably and sums each id's gathered
           rows in rank order, the JAX package's second ``dedup_rows``,
           before the update.  The packed layouts take the same route with
           the raw per-occurrence gradients (the JAX scatter-add tails),
           into B4 at the packed address or, fused, into kernel B3.

At world size 1 (``Mesh.single``) no collective runs and the update is the
single-device step's; an axis of size 1 skips its collectives as the JAX
``axis_size == 1`` fast paths do.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops.packed_table import (
    fused_gather,
    fused_rows_per_tile,
    packed_gather,
    rows_per_tile,
)
from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update
from fast_tffm_tpu_torch.parallel.mesh import (
    ROW_AXIS,
    Mesh,
    all_gather_cat,
    reduce_scatter_sum,
)

__all__ = [
    "owned_local_ids",
    "dedup_rows_padded",
    "apply_shard_adagrad",
    "serve_rows",
    "sharded_gather",
    "sharded_sparse_adagrad_update",
    "packed_sharded_gather",
    "packed_sharded_update",
    "packed_sharded_dense_update",
    "fused_sharded_gather",
    "fused_sharded_update",
]


def owned_local_ids(global_ids: torch.Tensor, shard_logical_rows: int, row_index: int,
                    sentinel: int):
    """Global row ids to this row shard's local ids: ``(local, owned)``,
    every unowned id replaced by ``sentinel`` (0 for masked gathers, past
    the end for updates)."""
    local = global_ids - row_index * shard_logical_rows
    owned = (local >= 0) & (local < shard_logical_rows)
    return torch.where(owned, local, torch.full_like(local, sentinel)), owned


def dedup_rows_padded(ids: torch.Tensor, row_grads: torch.Tensor, num_rows: int):
    """The JAX ``optim.dedup_rows``: ``(uids [M], gsum [M, D])``, the K
    unique ids ascending with their summed gradients first, then M − K
    sentinel ids ``num_rows`` with zero rows.  Static shapes and no host
    sync (a CUDA graph can hold it): stable sort, segment ids by cumsum,
    each segment summed in input order from 0 (``segment_reduce``, the
    order ``optim.sorted_segment_sum`` and the tail kernels sum in)."""
    m = ids.shape[0]
    sid, order = torch.sort(ids.reshape(-1), stable=True)
    new = torch.ones(m, dtype=torch.bool, device=ids.device)
    new[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(new, 0) - 1
    uids = torch.full((m,), num_rows, dtype=torch.int32, device=ids.device)
    uids.scatter_(0, seg, sid.to(torch.int32))
    counts = torch.zeros(m, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, seg, torch.ones_like(seg))
    gsum = torch.segment_reduce(row_grads.reshape(m, -1)[order], "sum", lengths=counts,
                                axis=0, unsafe=True)
    return uids, gsum


def _local32(guids: torch.Tensor, shard_rows: int, row_index: int, past_end: int):
    local, _ = owned_local_ids(guids.long(), shard_rows, row_index, past_end)
    return local.to(torch.int32)


def apply_shard_adagrad(table_shard, accum_shard, guids, ggsum, lr: float, base: int,
                        decay: float = 1.0):
    """Adagrad on this shard's rows (rows layout) from the world-gathered
    ``(guids [Q], ggsum [Q, D])`` (duplicates allowed, any order): ids
    outside ``[base, base + shard_rows)`` (other shards' rows, sentinels)
    drop.  One B4 launch: the stable sort of the local ids, each id's
    gathered rows summed in their order, the update; in place.  The one
    place the sharded rows Adagrad lives: the all-gather and the routed
    update end here."""
    shard_rows = table_shard.shape[0]
    local = guids.long() - base
    owned = (local >= 0) & (local < shard_rows)
    local = torch.where(owned, local, torch.full_like(local, shard_rows)).to(torch.int32)
    return rows_tail_adagrad_update(table_shard, accum_shard, local, ggsum, lr, decay=decay)


def serve_rows(table_shard, local_ids, layout: str, d: int):
    """The shard's rows for in-range local ids, in its layout."""
    if layout == "fused":
        return fused_gather(table_shard, local_ids, d)
    if layout == "packed":
        return packed_gather(table_shard, local_ids, d)
    return table_shard[local_ids.long()]


def _gather(table_shard, ids, mesh: Mesh, layout: str, d: int, shard_rows: int):
    if mesh.one(ROW_AXIS):
        # One row shard: the collectives are identities; the in-range
        # clamp-with-zero stays, as in the JAX fast path.
        in_range = (ids >= 0) & (ids < shard_rows)
        rows = serve_rows(table_shard, torch.where(in_range, ids, torch.zeros_like(ids)),
                          layout, d)
        return rows * in_range[..., None].to(rows.dtype)
    all_ids = all_gather_cat(ids, mesh.row_group, mesh.row)  # [R·B, N]
    local, owned = owned_local_ids(all_ids, shard_rows, mesh.row_index, 0)
    rows = serve_rows(table_shard, local, layout, d)
    rows = rows * owned[..., None].to(rows.dtype)
    return reduce_scatter_sum(rows, mesh.row_group, mesh.row)


def sharded_gather(table_shard: torch.Tensor, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's ``[B_local, N, D]`` rows from the row-sharded ``[V/R, D]``
    table (``ids``: this rank's global row ids)."""
    return _gather(table_shard, ids, mesh, "rows", table_shard.shape[-1], table_shard.shape[0])


def _world_gather(mesh: Mesh, *xs):
    return [all_gather_cat(x, None, mesh.size) for x in xs]


def sharded_sparse_adagrad_update(table_shard, accum_shard, ids, row_grads, lr: float,
                                  num_rows_global: int, mesh: Mesh, decay: float = 1.0):
    """Sparse Adagrad on the local row shard from every rank's
    per-occurrence gradients: the local dedup, the world all-gather in
    rank order, the shard apply (``apply_shard_adagrad``, the second dedup
    folded into kernel B4).  1 x 1 mesh: the single-device update."""
    d = table_shard.shape[-1]
    if mesh.single:
        return rows_tail_adagrad_update(table_shard, accum_shard, ids, row_grads, lr,
                                        decay=decay)
    uids, gsum = dedup_rows_padded(ids.reshape(-1), row_grads.reshape(-1, d), num_rows_global)
    all_uids, all_gsum = _world_gather(mesh, uids, gsum)
    return apply_shard_adagrad(table_shard, accum_shard, all_uids, all_gsum, lr,
                               mesh.row_index * table_shard.shape[0], decay=decay)


# --- lane-packed and fused shards ------------------------------------------
#
# The shard's logical row count is a multiple of its pack factor
# (train_step.packed_shard_meta pads the vocabulary to R·P), so the packed
# shard is a row block of the globally packed table and checkpoints stay
# layout-free.


def packed_sharded_gather(packed_shard, ids, d: int, shard_logical_rows: int, mesh: Mesh):
    """``sharded_gather`` on a lane-packed ``[VPs, 128]`` shard."""
    return _gather(packed_shard, ids, mesh, "packed", d, shard_logical_rows)


def fused_sharded_gather(fused_shard, ids, d: int, shard_logical_rows: int, mesh: Mesh):
    """``sharded_gather`` on a fused ``[VPf_s, 128]`` shard."""
    return _gather(fused_shard, ids, mesh, "fused", d, shard_logical_rows)


def packed_sharded_update(packed_shard, accum_shard, ids, row_grads, lr: float,
                          num_rows_global: int, shard_logical_rows: int, mesh: Mesh):
    """``packed_update = sorted``: the local dedup and world gather of the
    rows layout, then B4 at the packed address on the owned local ids
    (unowned and sentinel ids past the last physical row)."""
    d = row_grads.shape[-1]
    if mesh.single:
        return rows_tail_adagrad_update(packed_shard, accum_shard, ids, row_grads, lr,
                                        packed=True)
    uids, gsum = dedup_rows_padded(ids.reshape(-1), row_grads.reshape(-1, d), num_rows_global)
    all_uids, all_gsum = _world_gather(mesh, uids, gsum)
    past = packed_shard.shape[0] * rows_per_tile(d)
    local = _local32(all_uids, shard_logical_rows, mesh.row_index, past)
    return rows_tail_adagrad_update(packed_shard, accum_shard, local, all_gsum, lr, packed=True)


def packed_sharded_dense_update(packed_shard, accum_shard, ids, row_grads, lr: float,
                                shard_logical_rows: int, mesh: Mesh):
    """The JAX scatter-add tails (``packed_update`` auto, dense, compact):
    the RAW per-occurrence gradients all-gathered in rank order, each shard
    applying the ids it owns through B4 at the packed address, which sums
    every id's occurrences in that flat order."""
    d = row_grads.shape[-1]
    flat_ids, flat_g = ids.reshape(-1), row_grads.reshape(-1, d)
    if mesh.single:
        return rows_tail_adagrad_update(packed_shard, accum_shard, flat_ids, flat_g, lr,
                                        packed=True)
    all_ids, all_g = _world_gather(mesh, flat_ids, flat_g)
    if not mesh.one(ROW_AXIS):
        past = packed_shard.shape[0] * rows_per_tile(d)
        all_ids = _local32(all_ids, shard_logical_rows, mesh.row_index, past)
    return rows_tail_adagrad_update(packed_shard, accum_shard, all_ids, all_g, lr, packed=True)


def fused_sharded_update(fused_shard, ids, row_grads, lr: float, shard_logical_rows: int,
                         mesh: Mesh, k_cap: int = 0):
    """``packed_sharded_dense_update``'s fused twin: the raw gradients
    all-gathered, the owned ids applied through kernel B3."""
    d = row_grads.shape[-1]
    flat_ids, flat_g = ids.reshape(-1), row_grads.reshape(-1, d)
    if mesh.single:
        return fused_tail_adagrad_update(fused_shard, flat_ids, flat_g, lr, k_cap=k_cap)
    all_ids, all_g = _world_gather(mesh, flat_ids, flat_g)
    if not mesh.one(ROW_AXIS):
        past = fused_shard.shape[0] * fused_rows_per_tile(d)
        all_ids = _local32(all_ids, shard_logical_rows, mesh.row_index, past)
    return fused_tail_adagrad_update(fused_shard, all_ids, all_g, lr, k_cap=k_cap)

