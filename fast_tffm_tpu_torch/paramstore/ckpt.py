"""Tiered checkpoints: both tiers through ONE atomic-publish chain — the
counterpart of ``fast_tffm_tpu/paramstore/ckpt.py`` (the same members, the
same chain rules, so either package resumes the other's tiered run).

A tiered run's boundaries use the npz chain of every other run
(``checkpoint.py``: tmp + ``os.replace``, ``save_id``/``parent_sig``
links, the input cursor inside the same publish), with a payload that
spans both tiers:

  * **full save** — the dense leaves, the WHOLE hot tier (``table`` /
    ``table_accum`` are ``[H, D]`` / ``[H, A]``, so ``latest_step``, the
    cursor and the chain reader work unchanged), the residency set
    (``tier_hot_ids``), every pending row (``tier_cold_idx`` / ``_rows`` /
    ``_accum``), the store's identity (``tier_store``) and the save ids
    this publish supersedes (``tier_prev_sigs``).  The store files are the
    base of every other row and are never written again here;
  * **delta save** — the window's touched rows as LOGICAL rows in the
    ``save_delta`` format (``checkpoint_async``), so the chain reader needs
    nothing new.

Crash-consistency invariant 7: store writes come only after the boundary
npz holding the same rows is durable, so a row's latest value is always in
exactly one tier plus the chain; ``restore_tiered`` replays base + chain and
writes every chain row's cold half into the store again (idempotent redo,
which also repairs a kill mid-apply).  A store whose ``applied_sig`` names
a save the chain no longer contains is refused.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from fast_tffm_tpu_torch.checkpoint import (
    DEFAULT_CHUNK_BYTES,
    _cursor_entry,
    _npz_string,
    _open_npz,
    _write_npz_streaming,
    delta_paths,
    load_delta,
    read_delta_chain,
)
from fast_tffm_tpu_torch.paramstore.store import ColdStore
from fast_tffm_tpu_torch.resilience import maybe_publish_fault

__all__ = ["write_tiered_full", "restore_tiered", "is_tiered_checkpoint"]

_TIER_MARKER = "tier_hot_ids"

# The superseded-sig lineage cap: a crash between a full publish and its
# store apply leaves the store stamped with a sig of the chain that publish
# unlinked; the lineage keeps that distinguishable from a replaced store.
_PREV_SIGS_MAX = 256


def _superseded_sigs(path: str) -> list[str]:
    """Every save_id the on-disk base and deltas (and their recorded
    lineage) carry now: what the store's ``applied_sig`` may name after
    this publish unlinks them.  A torn file adds nothing."""
    sigs: list[str] = []

    def add(s):
        if s and s not in sigs:
            sigs.append(s)

    if os.path.isfile(path):
        try:
            with _open_npz(path) as z:
                if "tier_prev_sigs" in getattr(z, "files", ()):
                    for s in json.loads(bytes(np.asarray(z["tier_prev_sigs"]).tobytes()).decode()):
                        add(s)
                add(_npz_string(z, "save_id"))
        except (ValueError, OSError):
            pass
        for dp in delta_paths(path):
            try:
                with _open_npz(dp) as z:
                    add(_npz_string(z, "save_id"))
            except (ValueError, OSError):
                pass
    return sigs[-_PREV_SIGS_MAX:]


def is_tiered_checkpoint(z) -> bool:
    """True when an open npz holds a tiered (paramstore) checkpoint."""
    return _TIER_MARKER in getattr(z, "files", ())


def write_tiered_full(path: str, server, state, step: int, *, save_id: str,
                      cursor: dict | None = None, chunk_bytes: int | None = None,
                      staging=None) -> int:
    """Atomic tiered full save (see the module docstring); returns payload
    bytes.  The caller flushed the writeback first
    (``server.flush_writeback``), so pending names the latest value of
    every non-resident touched row.  The publish order is
    ``checkpoint.save_checkpoint``'s: tmp write, the old deltas unlinked
    newest first, the fault hook, ``os.replace``."""
    hot_t, hot_a = server.hot_rows_host(state)
    cold_idx, cold_t, cold_a = server.pending_snapshot()
    store_meta = {
        "fingerprint": server.store.fingerprint,
        "vocab": server.store.vocab,
        "row_dim": server.row_dim,
        "accum_width": server.accum_width,
        "hot_rows": server.hot_rows,
    }
    entries = {
        "table": hot_t,
        "table_accum": hot_a,
        "step": np.asarray(step, np.int32),
        "save_id": np.frombuffer(save_id.encode(), np.uint8),
        "published_at": np.float64(time.time()),
        _TIER_MARKER: np.asarray(server.residency.hot_ids, np.int64),
        "tier_cold_idx": cold_idx,
        "tier_cold_rows": cold_t,
        "tier_cold_accum": cold_a,
        "tier_store": np.frombuffer(json.dumps(store_meta, sort_keys=True).encode(), np.uint8),
        "tier_prev_sigs": np.frombuffer(json.dumps(_superseded_sigs(path)).encode(), np.uint8),
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
        nbytes = _write_npz_streaming(f, entries, chunk_bytes or DEFAULT_CHUNK_BYTES,
                                      staging=staging)
    for dp in reversed(delta_paths(path)):
        try:
            os.remove(dp)
        except OSError:
            pass
    maybe_publish_fault(path)
    os.replace(tmp, path)
    return nbytes


def restore_tiered(path: str, store: ColdStore, n_dense: int) -> dict:
    """Replay base + chain into (hot tier arrays, dense leaves, step),
    writing every chain row's cold half into the store again (idempotent
    redo; also the repair of a kill mid-apply).  Returns hot_ids / hot_t /
    hot_a / dense / dense_accum / step."""
    with _open_npz(path) as z:
        if not is_tiered_checkpoint(z):
            raise ValueError(
                f"{path!r} is not a tiered (paramstore) checkpoint — it has "
                "no residency members.  Resume it without [ParamStore] "
                "enabled, or start the tiered run fresh."
            )
        meta = json.loads(bytes(np.asarray(z["tier_store"]).tobytes()).decode())
        if meta.get("fingerprint") != store.fingerprint:
            raise ValueError(
                f"tiered checkpoint {path!r} was saved against parameter "
                f"store {meta.get('fingerprint')!r}, but {store.path!r} is "
                f"{store.fingerprint!r} — the store was replaced or "
                "recreated since this checkpoint; restore the original "
                "store directory or start fresh"
            )
        hot_ids = np.asarray(z[_TIER_MARKER], np.int64)
        hot_t = np.array(z["table"], np.float32)
        hot_a = np.array(z["table_accum"], np.float32)
        step = np.asarray(z["step"])
        dense = [np.asarray(z[f"dense_{i}"]) for i in range(n_dense)]
        dacc = [np.asarray(z[f"dense_accum_{i}"]) for i in range(n_dense)]
        cold_idx = np.asarray(z["tier_cold_idx"], np.int64)
        cold_t = np.asarray(z["tier_cold_rows"], np.float32)
        cold_a = np.asarray(z["tier_cold_accum"], np.float32)
        prev_sigs: list = []
        if "tier_prev_sigs" in z.files:
            prev_sigs = json.loads(bytes(np.asarray(z["tier_prev_sigs"]).tobytes()).decode())
    base_sig, chain = read_delta_chain(path)
    sigs = {m["save_id"] for m in chain}
    sigs.update(prev_sigs)
    if base_sig:
        sigs.add(base_sig)
    applied = store.applied_sig
    if applied is not None and applied not in sigs:
        raise ValueError(
            f"parameter store {store.path!r} has boundary {applied!r} "
            "applied, but the checkpoint chain at "
            f"{path!r} no longer contains that save — the store is AHEAD "
            "of the chain (crash inside a full-save publish window?).  "
            "The tiers cannot be mixed consistently; start the run fresh "
            "(or restore a matching store backup)."
        )
    if cold_idx.size:
        store.write_rows(cold_idx, cold_t, cold_a)
    h = hot_ids.size
    for m in chain:
        d = load_delta(m["path"], n_dense)
        idx = np.asarray(d["idx"], np.int64)
        pos = np.searchsorted(hot_ids, idx)
        pos_c = np.minimum(pos, max(0, h - 1))
        is_hot = (pos < h) & (hot_ids[pos_c] == idx) if h else np.zeros(idx.shape, bool)
        if is_hot.any():
            hot_t[pos_c[is_hot]] = d["table_rows"][is_hot]
            hot_a[pos_c[is_hot]] = d["accum_rows"][is_hot]
        if (~is_hot).any():
            store.write_rows(idx[~is_hot], d["table_rows"][~is_hot], d["accum_rows"][~is_hot])
        dense = d["dense"]
        dacc = d["dense_accum"]
        step = d["step"]
    head = chain[-1]["save_id"] if chain else base_sig
    store.flush()
    store.set_applied(head)
    return {"hot_ids": hot_ids, "hot_t": hot_t, "hot_a": hot_a, "dense": dense,
            "dense_accum": dacc, "step": step}
