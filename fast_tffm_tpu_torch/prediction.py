"""Load a model for inference, build its scoring function and run the
offline predict driver — the counterpart of ``fast_tffm_tpu/prediction.py``
``load_scoring_state`` / ``make_score_fn`` / ``predict`` (rows and packed
layouts) and ``dist_predict`` (the mesh of ranks, ``parallel/``).  ``predict``
reads text through the native parser (``thread_num``), FMB
``predict_files`` by memmap, and with ``binary_cache`` converts text once.
Its telemetry (``metrics_path``) is the JAX package's: kind=input, one
kind=profile record for ``predict_step``, kind=compile, kind=mem, a
kind=anomaly before a non-finite abort, kind=predict and the summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.data.native import best_parser, count_lines
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.profiling import CostLedger
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.trainer import make_packed_predict_step, make_predict_step, pack_state
from fast_tffm_tpu_torch.utils.prefetch import InputStats, prefetch

__all__ = ["ScoreFn", "load_scoring_state", "make_score_fn", "predict", "dist_predict"]


class ScoreFn(NamedTuple):
    """``fn(state, batch) -> sigmoid scores [B]`` plus the static facts its
    callers need.  The serving engine dispatches every flush through it."""

    fn: Callable
    model: Any  # built model (uses_fields, row_dim)
    max_nnz: int  # static feature width every batch carries

    def __call__(self, state, batch: Batch):
        return self.fn(state, batch)

    @property
    def uses_fields(self) -> bool:
        return self.model.uses_fields


def load_scoring_state(cfg: Config, log=print, device=None):
    """Build the model and restore ``cfg.model_file`` onto ``device``
    (None = cuda; no CUDA device raises).  Returns (model, state).

    Checkpoints hold the logical arrays, so ``table_layout = packed`` packs
    the table after the restore: plain packed, never the fused layout, as
    in the JAX package (scoring only gathers, and the plain gather serves a
    checkpoint of any accumulator)."""
    device = resolve_device(device)
    model = build_model(cfg)
    state = restore_checkpoint(cfg.model_file, device, n_dense=len(model.dense_names))
    v, d = state.table.shape
    if d != model.row_dim or v < model.vocabulary_size:
        raise ValueError(
            f"checkpoint {cfg.model_file!r} holds a [{v}, {d}] table; the config "
            f"needs at least [{model.vocabulary_size}, {model.row_dim}]"
        )
    if v > model.vocabulary_size:
        # Row padding of a sharded save: ids never reach past the vocabulary.
        state.table = state.table[: model.vocabulary_size]
    log(f"restored {cfg.model_file} at step {state.step} on {device}")
    if cfg.table_layout == "packed":
        state = pack_state(state, cfg.init_accumulator_value)
    return model, state


def make_score_fn(cfg: Config, state, max_nnz: int, model=None) -> ScoreFn:
    """The scoring step for ``state``'s layout (``state.layout``: rows,
    packed, or a live fused training state)."""
    if model is None:
        model = build_model(cfg)
    if state.layout == "rows":
        fn = make_predict_step(model)
    else:
        fn = make_packed_predict_step(model, fused=state.layout == "fused")
    return ScoreFn(fn=fn, model=model, max_nnz=int(max_nnz))


def predict(cfg: Config, log=print, device=None) -> str:
    """Single-device prediction — the reference's ``predict`` mode: restore
    ``cfg.model_file``, stream ``cfg.predict_files`` through the scoring
    step on ``device`` (None = cuda) and write one ``%.6f`` sigmoid score
    per input line to ``cfg.score_path``.  Returns the score path."""
    if not cfg.predict_files:
        raise ValueError("no predict_files configured")
    model, state = load_scoring_state(cfg, log, device)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    score = make_score_fn(cfg, state, max_nnz, model=model)
    return _run_predict(cfg, model, state, score, state.table.device, log)


def _run_predict(cfg: Config, model, state, score, device, log, *, world: int = 1,
                 rank: int = 0) -> str:
    """The predict loop: ``score(state, batch)`` gives the scores of the
    GLOBAL batch.  A rank of a multi-process run (``world`` > 1) streams
    only its ``B / P`` rows of every global batch (block-cyclic, padded to
    the global batch count) and rank 0 alone writes the score file and the
    telemetry."""
    total = count_lines(cfg.predict_files)  # the rows to score; padding follows them
    files, binary_cache, shard = cfg.predict_files, cfg.binary_cache, {}
    batch_size = cfg.batch_size
    if world > 1:
        from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache

        batch_size = cfg.batch_size // world
        shard = dict(shard_index=rank, shard_count=world, shard_block=batch_size,
                     pad_to_batches=-(-total // cfg.batch_size))
        if binary_cache:
            files = ensure_fmb_cache(
                files, vocabulary_size=cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
                max_nnz=score.max_nnz, parser=best_parser(cfg.thread_num), log=log,
                wait_for_peer=cfg.binary_cache_wait if rank != 0 else 0.0)
            binary_cache = False
        if rank == 0:
            log(f"predict input sharding: {total} rows over {world} processes")
    stats = InputStats()
    stream = prefetch(
        stats.timed(batch_stream(
            files,
            batch_size=batch_size,
            vocabulary_size=cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            max_nnz=score.max_nnz,
            parser=best_parser(cfg.thread_num),
            binary_cache=binary_cache,
            io_retries=cfg.io_retries,
            io_retry_backoff_s=cfg.io_retry_backoff_s,
            log=log,
            **shard,
        )),
        depth=cfg.queue_size,
        stats=stats,
    )
    lead = rank == 0
    monitor = RunMonitor(
        (cfg.metrics_path or None) if lead else None, run_id=cfg.telemetry_run_id,
        source="predict", stall_timeout_s=cfg.telemetry_stall_timeout_s,
        mem_every_s=cfg.telemetry_mem_every_s, device=device, log=log,
    )
    monitor.set_queue_depth_fn(stats.queue_depth)
    monitor.set_producer_alive_fn(stats.producer_alive)
    ledger = CostLedger(monitor) if cfg.telemetry_profile_costs else None
    n = batches = 0
    t_start = time.perf_counter()
    try:
        with open(cfg.score_path, "w") if lead else contextlib.nullcontext() as out:
            for parsed, w in stream:
                batch = Batch.from_parsed(parsed, w, device, with_fields=model.uses_fields)
                scores = score(state, batch).cpu().numpy()
                batches += 1
                monitor.on_dispatch(batches, warmup=(batches == 1))
                if ledger is not None and ledger.want("predict_step"):
                    ledger.stage("predict_step", examples=int(parsed.batch_size) * world)
                    ledger.flush(batches)
                if not np.isfinite(scores).all():
                    monitor.emit_anomaly(batches, None, event="nonfinite_scores", state=state)
                    raise RuntimeError(
                        "non-finite scores — a diverged model (non-finite weights); "
                        f"refusing to write a poisoned score file to {cfg.score_path}"
                    )
                take = min(total - n, len(scores))  # drop batch-size padding rows
                if out is not None:
                    for sc in scores[:take]:
                        out.write(f"{sc:.6f}\n")
                n += take
        dt = time.perf_counter() - t_start
        if rec := stats.drain():
            monitor.emit("input", step=batches, **rec)
        monitor.emit("predict", step=batches, examples=n,
                     examples_per_sec=round(n / dt, 1) if dt > 0 else None)
    finally:
        monitor.close()
    if lead:
        log(f"wrote {n} scores -> {cfg.score_path}")
    return cfg.score_path


def dist_predict(cfg: Config, log=print, device=None, mesh=None) -> str:
    """Mesh-sharded prediction — the reference's ``dist_predict`` mode on
    ``torch.distributed``: every rank restores its row shard of
    ``model_file`` (a packed config scores through the plain packed
    gather, whatever accumulator trained it), parses its ``B / P`` rows of
    every batch and scores them through the sharded lookup; the scores are
    all-gathered and rank 0 writes ``score_path``.  At world size 1 this is
    ``predict``.  Returns the score path."""
    from fast_tffm_tpu_torch.distributed import initialize_runtime
    from fast_tffm_tpu_torch.parallel import (
        check_batch_divides,
        make_mesh,
        make_sharded_predict_step,
        restore_orbax_shard,
        shard_state,
    )
    from fast_tffm_tpu_torch.parallel.multihost import local_device

    if not cfg.predict_files:
        raise ValueError("no predict_files configured")
    device = resolve_device(device)
    runtime = initialize_runtime(cfg, log=log, device=device)
    device = local_device(device)
    world, rank = runtime.process_count, runtime.process_index
    model = build_model(cfg)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    if mesh is None:
        mesh = make_mesh(cfg.data_parallel or None, cfg.row_parallel or cfg.vocabulary_block_num)
    check_batch_divides(cfg.batch_size, mesh)
    layout = "packed" if cfg.table_layout == "packed" else "rows"
    if world > 1 and os.path.isdir(cfg.model_file):
        # An orbax directory: each rank reads the chunks of its own rows.
        state = restore_orbax_shard(cfg.model_file, model, mesh, layout, device,
                                    cfg.init_accumulator_value, accum_width=None, log=log)
    else:
        logical = restore_checkpoint(cfg.model_file,
                                     device if world == 1 else torch.device("cpu"),
                                     n_dense=len(model.dense_names))
        if logical.table.shape[1] != model.row_dim:
            raise ValueError(
                f"checkpoint {cfg.model_file!r} holds a {tuple(logical.table.shape)} table; "
                f"this config scores rows of width {model.row_dim}"
            )
        state = shard_state(logical, model, mesh, cfg.init_accumulator_value, layout)
        state.table = state.table.to(device)
        state.dense = [p.to(device) for p in state.dense]
    log(f"restored {cfg.model_file} at step {state.step} on {device} (mesh {mesh.shape})")
    step = make_sharded_predict_step(
        model, mesh, lookup=cfg.lookup, capacity_factor=cfg.lookup_capacity_factor,
        overflow_mode=cfg.lookup_overflow, table_layout=cfg.table_layout,
        accumulator="element",  # scoring reads the plain packed table
    )
    score = ScoreFn(fn=step, model=model, max_nnz=int(max_nnz))
    return _run_predict(cfg, model, state, score, device, log, world=world, rank=rank)
