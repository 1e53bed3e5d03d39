"""Load a model for inference and build its scoring function — the
counterpart of ``fast_tffm_tpu/prediction.py::load_scoring_state`` /
``make_score_fn`` (rows layout; the offline ``predict`` entry point is a later
slice).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import make_predict_step

__all__ = ["ScoreFn", "load_scoring_state", "make_score_fn"]


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
    (None = cuda; no CUDA device raises).  Returns (model, state)."""
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
    return model, state


def make_score_fn(cfg: Config, state, max_nnz: int, model=None) -> ScoreFn:
    """The scoring step for ``state`` (rows layout)."""
    del state  # one layout in this slice; the packed layouts will read it
    if model is None:
        model = build_model(cfg)
    return ScoreFn(fn=make_predict_step(model), model=model, max_nnz=int(max_nnz))
