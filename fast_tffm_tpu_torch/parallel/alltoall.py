"""All-to-all routed embedding lookup and update (``[Distributed] lookup =
alltoall``) — the counterpart of ``fast_tffm_tpu/parallel/alltoall.py``.

Instead of every rank serving its row group's ids and reducing the masked
rows, each rank routes its ids to their home shards and gets back only its
own rows:

  1. owner = id // shard_rows (the contiguous row shards of the all-gather
     path, so checkpoints are the same);
  2. ids sort stably by owner into an ``[R, C]`` send buffer (C slots per
     destination, ``capacity_for``); ``all_to_all`` on the row group
     delivers each shard its requests;
  3. each shard serves its rows and a second ``all_to_all`` returns them;
     the inverse permutation restores batch order.

The update routes each rank's deduped (id, summed gradient) pairs the same
way, all-gathers the received buffers over the data group, and the shard
apply folds the second dedup into its kernel (``embedding``), summing in
world rank order as the all-gather path does.

**Overflow.** C is static.  ``routing_overflow`` reads only the ids, so the
training loop knows before a step whether any destination of any rank overflows
(one all-reduce of a flag): under ``lookup_overflow = fallback`` it runs
that step through the all-gather collectives instead (a host branch; the
JAX step's ``lax.cond``), under ``abort`` the routed step runs, its
overflowing rows come back NaN and the loss is NaN-poisoned so the run
stops before a save.  The buffers are built with static shapes and no
host sync (a dropped entry lands in a spare slot), so a CUDA graph holds
the routed step.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.parallel.embedding import (
    apply_shard_adagrad,
    dedup_rows_padded,
    owned_local_ids,
    serve_rows,
)
from fast_tffm_tpu_torch.parallel.mesh import Mesh, all_gather_cat, all_reduce_sum, all_to_all

__all__ = ["routed_gather", "routed_update", "routing_overflow", "overflow_flags",
           "capacity_for"]


def _counts(owner: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-bucket counts of ``owner`` (owners >= n_buckets not counted),
    without the host sync of ``torch.bincount``."""
    owner = owner.long().clamp(0, n_buckets)
    c = torch.zeros(n_buckets + 1, dtype=torch.int64, device=owner.device)
    c.scatter_add_(0, owner, torch.ones_like(owner))
    return c[:n_buckets]


def overflow_flags(ids: torch.Tensor, shard_rows: int, capacity: int, mesh: Mesh) -> list[bool]:
    """``routing_overflow`` for each leading slice of ``ids`` ([K, B, N]: the
    K steps of one call) with ONE all-reduce: the GLOBAL flags, identical
    on every rank, as host booleans."""
    r = mesh.row
    local = torch.stack([(_counts(x.reshape(-1) // shard_rows, r) > capacity).any()
                         for x in ids]).to(torch.int32)
    return [bool(v) for v in (all_reduce_sum(local, mesh.size) > 0).tolist()]


def routing_overflow(ids: torch.Tensor, shard_rows: int, capacity: int, mesh: Mesh) -> bool:
    """Would routing this batch overflow any destination of any rank?  The
    gather direction's bucket counts decide: per-owner unique counts never
    exceed per-owner occurrence counts, so "gather fits" implies "update
    fits"."""
    return overflow_flags(ids[None], shard_rows, capacity, mesh)[0]


def capacity_for(ids_per_chip: int, row_parallel: int, capacity_factor: float) -> int:
    """Per-destination slot count for M ids over R destinations:
    factor·M/R plus a binomial-tail term 4·√(M/R) + 8, rounded up to a
    multiple of 8, capped at M (C = M can never overflow)."""
    mean = ids_per_chip / row_parallel
    c = int(capacity_factor * mean + 4.0 * mean**0.5 + 8.0)
    c = ((c + 7) // 8) * 8
    return max(8, min(c, ids_per_chip))


def _bucketize(owner: torch.Tensor, n_buckets: int, capacity: int):
    """Stable-sort elements by ``owner`` and give each a send slot:
    ``(order, sorted_owner, send_pos, in_cap, overflow)``; element
    ``order[j]`` goes to ``[sorted_owner[j], send_pos[j]]``, where
    ``send_pos == capacity`` (over capacity) or an owner ``>= n_buckets``
    (a sentinel) is a slot that drops.  ``overflow`` is a 0-d tensor."""
    m = owner.shape[0]
    sorted_owner, order = torch.sort(owner.long(), stable=True)
    counts = _counts(owner, n_buckets)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(m, device=owner.device) - starts[sorted_owner.clamp(max=n_buckets - 1)]
    in_cap = pos < capacity
    send_pos = torch.where(in_cap, pos, torch.full_like(pos, capacity))
    return order, sorted_owner, send_pos, in_cap, (counts > capacity).any()


def _send(values: torch.Tensor, fill, sorted_owner, send_pos, n_buckets: int, capacity: int):
    """The ``[R, C, ...]`` send buffer of ``values`` (already in sorted
    order); dropped entries land in a spare row and column."""
    buf = torch.full((n_buckets + 1, capacity + 1, *values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    buf[sorted_owner.clamp(max=n_buckets), send_pos] = values
    return buf[:n_buckets, :capacity].contiguous()


def routed_gather(table_shard, ids, capacity: int, mesh: Mesh, *, d: int | None = None,
                  shard_logical_rows: int | None = None, fused: bool = False):
    """This rank's ``[B_local, N, D]`` rows by all-to-all id routing.
    ``d`` given: the shard is lane-packed (``fused``: the fused layout) with
    ``shard_logical_rows`` logical rows.  Rows of a batch whose routing
    overflowed a destination come back NaN (never silently wrong)."""
    layout = "rows" if d is None else ("fused" if fused else "packed")
    shard_rows = table_shard.shape[0] if d is None else shard_logical_rows
    d = table_shard.shape[-1] if d is None else d
    r = mesh.row
    b, n = ids.shape
    flat = ids.reshape(-1)
    owner = flat.long() // shard_rows
    order, sorted_owner, send_pos, in_cap, overflow = _bucketize(owner, r, capacity)
    send_ids = _send(flat[order], shard_rows * r, sorted_owner, send_pos, r, capacity)
    recv_ids = all_to_all(send_ids, mesh.row_group, r)  # [R, C]
    local, ok = owned_local_ids(recv_ids, shard_rows, mesh.row_index, 0)
    served = serve_rows(table_shard, local, layout, d)
    served = served * ok[..., None].to(served.dtype)
    recv_rows = all_to_all(served, mesh.row_group, r)  # [R, C, D]
    mine = recv_rows[sorted_owner.clamp(max=r - 1), send_pos.clamp(max=capacity - 1)]
    mine = mine * in_cap[:, None].to(mine.dtype)
    out = torch.empty_like(mine)
    out[order] = mine
    out = torch.where(overflow, torch.full_like(out, float("nan")), out)
    return out.reshape(b, n, d)


def routed_update(table_shard, accum_shard, ids, row_grads, lr: float, num_rows_global: int,
                  capacity: int, mesh: Mesh, *, shard_logical_rows: int | None = None,
                  layout: str = "rows", compact_cap: int = 0, decay: float = 1.0):
    """Sparse Adagrad via routed gradients: the local dedup, each (id,
    summed gradient) routed to its home shard over the row group, the
    received buffers all-gathered over the data group, the shard apply
    (second dedup folded into the kernel: B4 on the rows or packed layout,
    B3 on the fused one).  Returns ``(table, accum, overflow)``, ``overflow``
    the GLOBAL 0-d flag (any rank that dropped a contribution raises it)."""
    from fast_tffm_tpu_torch.ops.packed_table import fused_rows_per_tile, rows_per_tile
    from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update

    d = row_grads.shape[-1]
    shard_rows = table_shard.shape[0] if layout == "rows" else shard_logical_rows
    r = mesh.row
    uids, gsum = dedup_rows_padded(ids.reshape(-1), row_grads.reshape(-1, d), num_rows_global)
    # Sentinels route to owner R: not counted, dropped.
    owner = torch.where(uids >= num_rows_global, torch.full_like(uids, r),
                        uids // shard_rows).long()
    order, sorted_owner, send_pos, _, overflow = _bucketize(owner, r, capacity)
    send_ids = _send(uids[order], num_rows_global, sorted_owner, send_pos, r, capacity)
    send_g = _send(gsum[order], 0.0, sorted_owner, send_pos, r, capacity)
    recv_ids = all_to_all(send_ids, mesh.row_group, r)  # [R, C]
    recv_g = all_to_all(send_g, mesh.row_group, r)  # [R, C, D]
    # The data-axis union: every replica of this shard applies the same update.
    all_ids = all_gather_cat(recv_ids.reshape(-1), mesh.data_group, mesh.data)
    all_g = all_gather_cat(recv_g.reshape(-1, d), mesh.data_group, mesh.data)
    if layout == "rows":
        table_shard, accum_shard = apply_shard_adagrad(
            table_shard, accum_shard, all_ids, all_g, lr, mesh.row_index * shard_rows,
            decay=decay)
    else:
        p = fused_rows_per_tile(d) if layout == "fused" else rows_per_tile(d)
        local, _ = owned_local_ids(all_ids.long(), shard_rows, mesh.row_index,
                                   table_shard.shape[0] * p)
        local = local.to(torch.int32)
        if layout == "fused":
            table_shard = fused_tail_adagrad_update(table_shard, local, all_g, lr,
                                                    k_cap=compact_cap)
        else:
            table_shard, accum_shard = rows_tail_adagrad_update(
                table_shard, accum_shard, local, all_g, lr, packed=True)
    overflow = all_reduce_sum(overflow.to(torch.int32), mesh.size) > 0
    return table_shard, accum_shard, overflow
