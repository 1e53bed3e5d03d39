"""Model state, the train steps and the predict step — the counterpart of
``fast_tffm_tpu/trainer.py`` (single device, rows layout).

One step is gather → scorer (its backward a CUDA kernel at order ≥ 3) →
loss → dedup → sparse Adagrad.  The JAX step is one jitted program that
donates the state; here the step runs eagerly and updates the state's
tensors in place, which is the port's counterpart of donation: a step
never copies the ``[V, D]`` table.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch, logistic_loss
from fast_tffm_tpu_torch.ops.tail import rows_tail_adagrad_update
from fast_tffm_tpu_torch.optim import dense_adagrad_update, init_table_adagrad

__all__ = [
    "TrainState",
    "init_state",
    "batch_loss",
    "train_step_body",
    "make_train_step",
    "make_decayed_body",
    "make_pallas_tail_body",
    "make_predict_step",
]


@dataclasses.dataclass
class TrainState:
    """The ``[V, D]`` table, the dense parameter leaves (in the JAX
    package's ``jax.tree.flatten`` order; none for FM), the step, and the
    Adagrad accumulators: ``table_accum`` [V, D] (element) or [V, 1] (row),
    ``dense_accum`` one per dense leaf.  Scoring reads only the first
    three; a state restored for scoring carries no accumulators."""

    table: torch.Tensor
    dense: list[torch.Tensor]
    step: int
    table_accum: torch.Tensor | None = None
    dense_accum: list[torch.Tensor] = dataclasses.field(default_factory=list)


def init_state(
    model,
    generator: torch.Generator,
    init_accumulator_value: float = 0.1,
    accumulator: str = "element",
) -> TrainState:
    """A fresh state on the generator's device.  ``accumulator``: ``element``
    ([V, D], TF-Adagrad parity) or ``row`` ([V, 1]).  The draws are not the
    JAX package's (``jax.random`` and ``torch.Generator`` differ), so
    cross-package comparisons start from one shared npz instead."""
    table = model.init_table(generator)
    dense = model.init_dense(generator)
    return TrainState(
        table=table,
        dense=dense,
        step=0,
        table_accum=init_table_adagrad(table, init_accumulator_value, accumulator),
        dense_accum=[torch.full_like(p, init_accumulator_value) for p in dense],
    )


def batch_loss(model, table_rows, dense, batch: Batch):
    """(total loss with L2, plain data loss)."""
    scores = model.score(table_rows, dense, batch)
    data_loss = logistic_loss(scores, batch.labels, batch.weights)
    reg = model.regularization(table_rows, dense, batch)
    return data_loss + reg, data_loss


def _grads(model, state: TrainState, batch: Batch):
    """Gather, loss and the gradients of the total loss with respect to
    the gathered rows and the dense leaves.  The gather is a detached leaf
    so the backward never reaches (or allocates a gradient for) the table."""
    rows = state.table[batch.ids].detach().requires_grad_(True)  # [B, N, D]
    dense = [p.detach().requires_grad_(True) for p in state.dense]
    total, data_loss = batch_loss(model, rows, dense, batch)
    g_rows, *g_dense = torch.autograd.grad(total, [rows, *dense])
    return data_loss.detach(), g_rows, g_dense


def train_step_body(model, learning_rate: float, state: TrainState, batch: Batch, decay: float = 1.0):
    """The single-device step: gather → scorer → loss → dedup → the rows
    Adagrad tail (``ops/tail.py::rows_tail_adagrad_update``), in place.  On
    a CUDA state the tail is the kernel ``csrc/rows_tail_adagrad.cu``; on a
    CPU state its plain twin.  ``decay`` is ``[Online] adagrad_decay`` γ
    (lazy touched-row decay)."""
    data_loss, g_rows, g_dense = _grads(model, state, batch)
    rows_tail_adagrad_update(
        state.table, state.table_accum, batch.ids, g_rows, learning_rate, decay=decay
    )
    if state.dense:
        dense_adagrad_update(state.dense, state.dense_accum, g_dense, learning_rate, decay)
    state.step += 1
    return state, data_loss


def make_train_step(model, learning_rate: float, decay: float = 1.0, body=None):
    """Returns ``step(state, batch) -> (state, data_loss)``, the loss a 0-d
    tensor on the batch's device.  The state's tensors update in place;
    callers rebind ``state`` to the returned value as with the JAX step.

    ``body`` overrides the step body (same ``(model, lr, state, batch)``
    contract as the JAX package's)."""
    body = body or make_decayed_body(decay)

    def step(state: TrainState, batch: Batch):
        return body(model, learning_rate, state, batch)

    return step


def make_decayed_body(decay: float = 1.0):
    """``train_step_body`` with ``[Online] adagrad_decay`` γ baked in."""
    return lambda model, learning_rate, state, batch: train_step_body(
        model, learning_rate, state, batch, decay
    )


# The JAX package's name for the body whose tail is its Pallas rows kernel;
# here every body's tail is the rows kernel already.
make_pallas_tail_body = make_decayed_body


def make_predict_step(model):
    """Returns ``predict(state, batch) -> sigmoid scores [B]`` on the batch's device."""

    @torch.inference_mode()
    def predict(state: TrainState, batch: Batch) -> torch.Tensor:
        rows = state.table[batch.ids]  # the gather stays plain indexing, as in XLA
        return torch.sigmoid(model.score(rows, state.dense, batch))

    return predict
