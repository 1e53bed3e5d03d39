"""Load a model for inference, build its scoring function and run the
offline predict driver — the counterpart of ``fast_tffm_tpu/prediction.py``
``load_scoring_state`` / ``make_score_fn`` / ``predict`` (rows and packed
layouts, single process; ``dist_predict`` is a later slice).  ``predict``
reads text through the native parser (``thread_num``), FMB
``predict_files`` by memmap, and with ``binary_cache`` converts text once.
Its telemetry (``metrics_path``) is the JAX package's: kind=input, one
kind=profile record for ``predict_step``, kind=compile, kind=mem, a
kind=anomaly before a non-finite abort, kind=predict and the summary.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import numpy as np

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

__all__ = ["ScoreFn", "load_scoring_state", "make_score_fn", "predict"]


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
    device = state.table.device
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    score = make_score_fn(cfg, state, max_nnz, model=model)
    total = count_lines(cfg.predict_files)  # the rows to score; padding follows them
    stats = InputStats()
    stream = prefetch(
        stats.timed(batch_stream(
            cfg.predict_files,
            batch_size=cfg.batch_size,
            vocabulary_size=cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            max_nnz=score.max_nnz,
            parser=best_parser(cfg.thread_num),
            binary_cache=cfg.binary_cache,
            io_retries=cfg.io_retries,
            io_retry_backoff_s=cfg.io_retry_backoff_s,
            log=log,
        )),
        depth=cfg.queue_size,
        stats=stats,
    )
    monitor = RunMonitor(
        cfg.metrics_path or None, run_id=cfg.telemetry_run_id, source="predict",
        stall_timeout_s=cfg.telemetry_stall_timeout_s, mem_every_s=cfg.telemetry_mem_every_s,
        device=device, log=log,
    )
    monitor.set_queue_depth_fn(stats.queue_depth)
    monitor.set_producer_alive_fn(stats.producer_alive)
    ledger = CostLedger(monitor) if cfg.telemetry_profile_costs else None
    n = batches = 0
    t_start = time.perf_counter()
    try:
        with open(cfg.score_path, "w") as out:
            for parsed, w in stream:
                batch = Batch.from_parsed(parsed, w, device, with_fields=model.uses_fields)
                scores = score(state, batch).cpu().numpy()
                batches += 1
                monitor.on_dispatch(batches, warmup=(batches == 1))
                if ledger is not None and ledger.want("predict_step"):
                    ledger.stage("predict_step", examples=int(parsed.batch_size))
                    ledger.flush(batches)
                if not np.isfinite(scores).all():
                    monitor.emit_anomaly(batches, None, event="nonfinite_scores", state=state)
                    raise RuntimeError(
                        "non-finite scores — a diverged model (non-finite weights); "
                        f"refusing to write a poisoned score file to {cfg.score_path}"
                    )
                take = min(total - n, len(scores))  # drop batch-size padding rows
                for s in scores[:take]:
                    out.write(f"{s:.6f}\n")
                n += take
        dt = time.perf_counter() - t_start
        if rec := stats.drain():
            monitor.emit("input", step=batches, **rec)
        monitor.emit("predict", step=batches, examples=n,
                     examples_per_sec=round(n / dt, 1) if dt > 0 else None)
    finally:
        monitor.close()
    log(f"wrote {n} scores -> {cfg.score_path}")
    return cfg.score_path
