"""Model state and the predict step — the serving half of
``fast_tffm_tpu/trainer.py`` (the train steps come with the training slice).
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch

__all__ = ["TrainState", "make_predict_step"]


@dataclasses.dataclass
class TrainState:
    """What scoring reads: the ``[V, D]`` table, the dense parameter leaves
    (in the JAX package's ``jax.tree.flatten`` order; none for FM) and the
    step.  The Adagrad accumulators join with the training slice."""

    table: torch.Tensor
    dense: list[torch.Tensor]
    step: int


def make_predict_step(model):
    """Returns ``predict(state, batch) -> sigmoid scores [B]`` on the batch's device."""

    @torch.inference_mode()
    def predict(state: TrainState, batch: Batch) -> torch.Tensor:
        rows = state.table[batch.ids]  # the gather stays plain indexing, as in XLA
        return torch.sigmoid(model.score(rows, state.dense, batch))

    return predict
