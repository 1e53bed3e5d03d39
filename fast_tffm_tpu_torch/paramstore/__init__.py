"""Tiered host/device parameter store — the counterpart of
``fast_tffm_tpu/paramstore/``.

  * ``store.py``     — the cold tier: the full logical table in memmap
                       files (sparse files, lazy row init), numpy;
  * ``residency.py`` — the hot set and the per-batch id resolution, numpy;
  * ``tiered.py``    — the runtime: ``TieredParamServer`` (staging,
                       writeback, pending overlay, coherency) and
                       ``TieredConverter`` (the prefetch thread's resolve
                       and one-buffer shipping on the packed wire);
  * ``ckpt.py``      — both tiers through one atomic-publish chain.

``open_tiered_run`` is the training entry: it builds (server, compact
TrainState on the device, resume cursor) for ``training.train``'s tiered
branch.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fast_tffm_tpu_torch.paramstore.ckpt import (
    is_tiered_checkpoint,
    restore_tiered,
    write_tiered_full,
)
from fast_tffm_tpu_torch.paramstore.residency import ResidencyMap, choose_hot_ids
from fast_tffm_tpu_torch.paramstore.store import ColdStore, hashed_uniform_rows
from fast_tffm_tpu_torch.paramstore.tiered import (
    TieredBatch,
    TieredConverter,
    TieredParamServer,
)

__all__ = [
    "ColdStore",
    "MATERIALIZE_MAX_ROWS",
    "ResidencyMap",
    "TieredBatch",
    "TieredConverter",
    "TieredParamServer",
    "choose_hot_ids",
    "hashed_uniform_rows",
    "is_tiered_checkpoint",
    "open_tiered_run",
    "restore_tiered",
    "write_tiered_full",
]

# ``materialize = auto`` writes the init draw into the store up to this many
# rows (a tiered run is then bitwise the resident run); a larger store is
# lazy (hashed per-row init: no resident run exists at such sizes).
MATERIALIZE_MAX_ROWS = 1 << 21


def _sample_ids(cfg, max_nnz: int, n_batches: int):
    """The id arrays of the first ``n_batches`` parsed train batches: the
    exact-frequency sample of the ``sample`` residency policy."""
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    raw = batch_stream(
        tuple(cfg.train_files),
        batch_size=cfg.batch_size,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        max_nnz=max_nnz,
        epochs=1,
        parser=best_parser(cfg.thread_num),
    )
    for i, (p, _w) in enumerate(raw):
        if i >= n_batches:
            break
        yield p.ids


def _host(tensors) -> list[np.ndarray]:
    return [t.detach().numpy() for t in tensors]


def open_tiered_run(cfg, model, max_nnz: int, *, resume: bool, device, log=print):
    """(server, compact TrainState on ``device``, start cursor) of a tiered
    run.

    A fresh run chooses the hot set (``[ParamStore] residency``), then
    creates the store: with the exact init draw of ``trainer.init_state``
    at a small vocabulary, lazy beyond.  The draw is made on the host (a
    CPU generator seeded 0, as a resident CPU run's): the store is a host
    object, so its init is the same whatever device trains on it, and a
    card run and a CPU run of one config start from the same rows.  A lazy
    store's dense leaves are the model's first draw from that generator.
    ``resume`` restores BOTH tiers from the chain (``restore_tiered``) and
    takes the residency from the checkpoint, so the resumed run's remapping
    is the uninterrupted one's."""
    from fast_tffm_tpu_torch.checkpoint import read_input_cursor
    from fast_tffm_tpu_torch.trainer import init_state

    vocab = int(cfg.vocabulary_size)
    accum_width = model.row_dim if cfg.adagrad_accumulator == "element" else 1
    store_dir = cfg.paramstore_dir or cfg.model_file + ".store"
    miss_rows = cfg.paramstore_miss_rows or (cfg.batch_size * max_nnz * cfg.steps_per_call)
    init_acc = float(cfg.init_accumulator_value)
    init_range = float(getattr(model, "init_value_range", 0.01))

    if resume and not os.path.isfile(cfg.model_file):
        log(f"warning: --resume but no checkpoint at {cfg.model_file} — "
            "starting fresh (crash before the first publish?)")
        resume = False
    if resume:
        store = ColdStore.open(store_dir)
        rec = restore_tiered(cfg.model_file, store, len(model.dense_names))
        hot_ids = rec["hot_ids"]
        if int(hot_ids.size) != int(cfg.paramstore_hot_rows):
            log(f"note: resuming with the checkpoint's residency ({hot_ids.size} hot rows; "
                f"[ParamStore] hot_rows = {cfg.paramstore_hot_rows} ignored for this run)")
        server = TieredParamServer(store, hot_ids, miss_rows, model, init_accum=init_acc)
        state = _compact_state(server, rec["hot_t"], rec["hot_a"], rec["dense"],
                               rec["dense_accum"], int(rec["step"]), init_acc, device)
        log(f"resumed tiered run from {cfg.model_file} at step {int(rec['step'])} "
            f"(hot {server.hot_rows} rows, store {store.vocab} rows)")
        return server, state, read_input_cursor(cfg.model_file)

    policy = cfg.paramstore_residency
    hot_ids = choose_hot_ids(
        policy, cfg.paramstore_hot_rows, vocab,
        sample_batches=(_sample_ids(cfg, max_nnz, cfg.paramstore_sample_batches)
                        if policy == "sample" else None),
    )
    materialize = cfg.paramstore_materialize == "always" or (
        cfg.paramstore_materialize == "auto" and vocab <= MATERIALIZE_MAX_ROWS
    )
    generator = torch.Generator().manual_seed(0)
    if materialize:
        logical = init_state(model, generator, init_acc, cfg.adagrad_accumulator)
        store = ColdStore.create(
            store_dir, vocab=vocab, row_dim=model.row_dim, accum_width=accum_width, seed=0,
            init_range=init_range, init_accum=init_acc,
            init_table=logical.table.numpy(), init_accum_arr=logical.table_accum.numpy(),
        )
        dense, dense_acc = _host(logical.dense), _host(logical.dense_accum)
        del logical
    else:
        store = ColdStore.create(
            store_dir, vocab=vocab, row_dim=model.row_dim, accum_width=accum_width, seed=0,
            init_range=init_range, init_accum=init_acc,
        )
        dense = _host(model.init_dense(generator))
        dense_acc = [np.full(p.shape, init_acc, np.float32) for p in dense]
        log(f"paramstore: lazy cold store for {vocab} rows (beyond the "
            f"{MATERIALIZE_MAX_ROWS}-row materialize bound; rows init on first touch)")
    server = TieredParamServer(store, hot_ids, miss_rows, model, init_accum=init_acc)
    hot_t, hot_a = store.read_rows(server.residency.hot_ids)
    state = _compact_state(server, hot_t, hot_a, dense, dense_acc, 0, init_acc, device)
    log(f"paramstore: hot tier {server.hot_rows} rows + staging {server.miss_rows} rows on "
        f"the device ({server.capacity * (model.row_dim + accum_width) * 4 / 2**20:.1f} MiB), "
        f"cold store {vocab} rows at {store_dir}")
    return server, state, None


def _compact_state(server, hot_t, hot_a, dense, dense_acc, step: int, init_acc: float, device):
    """The device state over the compact ``[C, D]`` table: the hot rows in
    slots ``[0, H)``, the staging slots zero with the init accumulator."""
    from fast_tffm_tpu_torch.weights import from_jax_arrays

    c, d, a = server.capacity, server.row_dim, server.accum_width
    table = np.zeros((c, d), np.float32)
    table[: server.hot_rows] = hot_t
    accum = np.full((c, a), np.float32(init_acc), np.float32)
    accum[: server.hot_rows] = hot_a
    return from_jax_arrays(table, dense, step, device, table_accum=accum, dense_accum=dense_acc)
