"""Hot-tier residency: which logical rows live on the device, and the
host-side id resolution every batch goes through — the counterpart of
``fast_tffm_tpu/paramstore/residency.py`` (numpy; the same decisions).

The hot set is chosen ONCE per run, deterministically (``--resume``
restores the exact set from the checkpoint, so a resumed run's remapping,
and its loss sequence, are the uninterrupted run's):

  * ``sample`` (default) — exact frequency count over the first N batches
    of the train stream, top-K by (count desc, id asc);
  * ``first`` — ids [0, K);
  * ``file:PATH`` — an id array (.npy, or one id per line), e.g. exported
    from the heavy-hitter statistics; the first K distinct ids win.

Resolution (``ResidencyMap.resolve``) is numpy over the sorted hot ids: a
hot id maps to its rank (its device slot), a missed id to a staging slot
of this call.  Slots are ranks in sorted order, so the mapping is a pure
function of the hot set.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

__all__ = ["ResidencyMap", "choose_hot_ids", "Resolved"]


class Resolved(NamedTuple):
    """One (super)batch's residency resolution (host side)."""

    remapped: list  # per-micro-batch [B, N] int32 LOCAL ids (slots)
    miss_ids: np.ndarray  # unique missed LOGICAL ids (sorted), [m]
    hit_slots: int  # gather slots that hit the hot tier
    total_slots: int  # all gather slots (B*N per micro batch)
    unique_ids: int  # unique logical ids across the superbatch


class ResidencyMap:
    def __init__(self, hot_ids: np.ndarray):
        hot = np.unique(np.asarray(hot_ids, np.int64))
        if hot.size != np.asarray(hot_ids).size:
            raise ValueError("hot_ids must be unique")
        self.hot_ids = hot  # sorted; slot of hot_ids[i] is i
        self.hot_rows = int(hot.size)

    def lookup(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(hit mask, hot slot per id) for flat logical ``ids``."""
        pos = np.searchsorted(self.hot_ids, ids)
        pos_c = np.minimum(pos, max(0, self.hot_rows - 1))
        hit = (
            (pos < self.hot_rows) & (self.hot_ids[pos_c] == ids)
            if self.hot_rows
            else np.zeros(ids.shape, bool)
        )
        return hit, pos_c.astype(np.int64)

    def resolve(self, ids_seq: list[np.ndarray], miss_capacity: int) -> Resolved:
        """Remap a call's logical ids to device slots.

        Hot ids map to their rank slot; every unique missed id gets a
        staging slot ``hot_rows + rank`` (its rank within the sorted unique
        misses of THIS call), so a missed row is staged (and crosses the
        wire) once per call however many slots repeat it.  The JAX
        package's mapping, computed once per unique id (a sorted lookup)
        and spread back to the slots."""
        flats = [np.asarray(a).reshape(-1) for a in ids_seq]
        all_flat = np.concatenate(flats) if len(flats) > 1 else flats[0]
        uniq, inverse, counts = np.unique(all_flat, return_inverse=True, return_counts=True)
        hit, slot = self.lookup(uniq)
        miss_ids = uniq[~hit]
        if miss_ids.size > miss_capacity:
            raise ValueError(
                f"paramstore: a superbatch touches {miss_ids.size} unique "
                f"non-resident rows, over the staging capacity "
                f"{miss_capacity} — raise [ParamStore] miss_rows (or "
                "hot_rows), or lower batch_size/steps_per_call"
            )
        local_u = np.where(hit, slot, 0)
        local_u[~hit] = self.hot_rows + np.arange(miss_ids.size)
        local = local_u[inverse.reshape(-1)].astype(np.int32)
        remapped, o = [], 0
        for a, flat in zip(ids_seq, flats):
            remapped.append(local[o : o + flat.size].reshape(np.asarray(a).shape))
            o += flat.size
        return Resolved(
            remapped=remapped,
            miss_ids=miss_ids,
            hit_slots=int(counts[hit].sum()),
            total_slots=int(all_flat.size),
            unique_ids=int(uniq.size),
        )


def choose_hot_ids(
    policy: str,
    hot_rows: int,
    vocab: int,
    *,
    sample_batches=None,
) -> np.ndarray:
    """The run-start residency decision (see module docstring).
    ``sample_batches`` is an iterator of host id arrays for the
    ``sample`` policy (training hands it the first N parsed batches of
    the train stream)."""
    k = min(int(hot_rows), int(vocab))
    if policy == "first":
        return np.arange(k, dtype=np.int64)
    if policy.startswith("file:"):
        path = policy[len("file:"):]
        if not os.path.exists(path):
            raise ValueError(f"[ParamStore] residency file not found: {path!r}")
        if path.endswith(".npy"):
            ids = np.load(path).astype(np.int64).reshape(-1)
        else:
            with open(path) as f:
                ids = np.array(
                    [int(x) for x in f.read().split() if x.strip()], np.int64
                )
        ids = ids[(ids >= 0) & (ids < vocab)]
        uniq = np.unique(ids)
        if uniq.size < k:
            raise ValueError(
                f"[ParamStore] residency file {path!r} holds {uniq.size} "
                f"distinct in-range ids, fewer than hot_rows = {k}"
            )
        # Preserve the file's ranking: first K distinct ids in file order.
        seen: set = set()
        out = []
        for i in ids.tolist():
            if i not in seen:
                seen.add(i)
                out.append(i)
                if len(out) == k:
                    break
        return np.array(out, np.int64)
    if policy != "sample":
        raise ValueError(
            f"unknown [ParamStore] residency policy {policy!r} "
            "(sample | first | file:PATH)"
        )
    counts: dict = {}
    ids_all = []
    n = 0
    for arr in sample_batches or ():
        ids_all.append(np.asarray(arr, np.int64).reshape(-1))
        n += 1
    if not ids_all:
        # No sample available (empty stream): fall back to the first-K
        # deterministic set rather than failing a run that would work.
        return np.arange(k, dtype=np.int64)
    flat = np.concatenate(ids_all)
    uniq, cnt = np.unique(flat, return_counts=True)
    # Top-K by (count desc, id asc) — a full deterministic order, so ties
    # cannot reshuffle residency between runs.
    order = np.lexsort((uniq, -cnt))
    top = uniq[order[:k]]
    if top.size < k:
        # Fewer distinct ids than hot_rows in the sample: fill with the
        # smallest unseen ids (deterministic).
        fill = np.setdiff1d(np.arange(min(vocab, k * 2), dtype=np.int64), top)
        top = np.concatenate([top, fill[: k - top.size]])
    return np.sort(top)
