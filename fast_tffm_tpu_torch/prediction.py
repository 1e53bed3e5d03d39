"""Load a model for inference, build its scoring function and run the
offline predict driver — the counterpart of ``fast_tffm_tpu/prediction.py``
``load_scoring_state`` / ``make_score_fn`` / ``predict`` (rows and packed
layouts, single process; ``dist_predict`` is a later slice).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model, refuse_later_slices
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import make_packed_predict_step, make_predict_step, pack_state
from fast_tffm_tpu_torch.utils.prefetch import prefetch

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
    state = restore_checkpoint(cfg.model_file, device)
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
    refuse_later_slices("predict", [
        (cfg.binary_cache, "binary_cache = true (FMB input)"),
        (bool(cfg.metrics_path), "metrics_path (telemetry)"),
    ])
    if not cfg.predict_files:
        raise ValueError("no predict_files configured")
    model, state = load_scoring_state(cfg, log, device)
    device = state.table.device
    score = make_score_fn(cfg, state, scan_max_nnz(cfg), model=model)
    stream = prefetch(
        batch_stream(
            cfg.predict_files,
            batch_size=cfg.batch_size,
            vocabulary_size=cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id,
            max_nnz=score.max_nnz,
        ),
        depth=cfg.queue_size,
    )
    n = 0
    with open(cfg.score_path, "w") as out:
        for parsed, w in stream:
            scores = score(state, Batch.from_parsed(parsed, w, device)).cpu().numpy()
            if not np.isfinite(scores).all():
                raise RuntimeError(
                    "non-finite scores — a diverged model (non-finite weights); "
                    f"refusing to write a poisoned score file to {cfg.score_path}"
                )
            real = w > 0  # drop batch-size padding rows
            for s in scores[real]:
                out.write(f"{s:.6f}\n")
            n += int(real.sum())
    log(f"wrote {n} scores -> {cfg.score_path}")
    return cfg.score_path
