"""Model state, the train steps and the predict steps — the counterpart of
``fast_tffm_tpu/trainer.py`` (single device; the rows layout and the fused
lane-packed layout).

One step is gather → scorer (its backward a CUDA kernel at order ≥ 3) →
loss → sparse Adagrad (on a CUDA state: ``torch.sort`` of the ids, then one
CUDA kernel per layout that dedups and updates; on a CPU state: dedup, then
the plain update).  The JAX step is
one jitted program that donates the state; here the step runs eagerly and
updates the state's tensors in place, which is the port's counterpart of
donation: a step never copies the table.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch, logistic_loss
from fast_tffm_tpu_torch.ops.packed_table import (
    fused_gather,
    pack_fused,
    pack_table,
    packed_gather,
    unpack_fused,
)
from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update
from fast_tffm_tpu_torch.optim import dense_adagrad_update, init_table_adagrad

__all__ = [
    "LAYOUTS",
    "TrainState",
    "init_state",
    "batch_loss",
    "train_step_body",
    "make_train_step",
    "make_decayed_body",
    "make_pallas_tail_body",
    "make_predict_step",
    "pack_state",
    "unpack_state",
    "init_packed_state",
    "packed_train_step_body",
    "make_packed_train_step",
    "make_packed_predict_step",
]

LAYOUTS = ("rows", "packed", "fused")


@dataclasses.dataclass
class TrainState:
    """The table, the dense parameter leaves (in the JAX package's
    ``jax.tree.flatten`` order; none for FM), the step, and the Adagrad
    accumulators, ``dense_accum`` one per dense leaf.  ``layout`` names the
    table's physical layout:

    * ``rows``: ``table`` [V, D]; ``table_accum`` [V, D] (element) or
      [V, 1] (row);
    * ``packed``: ``table`` the [VP, 128] lane-packed array
      (``ops/packed_table.pack_table``), for scoring;
    * ``fused``: ``table`` the [VPf, 128] fused array, each row's
      accumulator in its own slot (``pack_fused``); no ``table_accum``.

    (The JAX package marks a fused state by an empty [0, 1] accumulator.)
    Scoring reads only the table, the dense leaves and the step; a state
    restored for scoring carries no accumulators."""

    table: torch.Tensor
    dense: list[torch.Tensor]
    step: int
    table_accum: torch.Tensor | None = None
    dense_accum: list[torch.Tensor] = dataclasses.field(default_factory=list)
    layout: str = "rows"

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"unknown layout {self.layout!r} ({' | '.join(LAYOUTS)})")


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


def _grads(model, rows: torch.Tensor, state: TrainState, batch: Batch):
    """Loss and the gradients of the total loss with respect to the
    gathered rows and the dense leaves.  The rows are a detached leaf so
    the backward never reaches (or allocates a gradient for) the table."""
    rows = rows.detach().requires_grad_(True)  # [B, N, D]
    dense = [p.detach().requires_grad_(True) for p in state.dense]
    total, data_loss = batch_loss(model, rows, dense, batch)
    g_rows, *g_dense = torch.autograd.grad(total, [rows, *dense])
    return data_loss.detach(), g_rows, g_dense


def _finish(learning_rate: float, state: TrainState, g_dense, decay: float = 1.0):
    if state.dense:
        dense_adagrad_update(state.dense, state.dense_accum, g_dense, learning_rate, decay)
    state.step += 1
    return state


def train_step_body(model, learning_rate: float, state: TrainState, batch: Batch, decay: float = 1.0):
    """The single-device step on a rows-layout state: gather → scorer → loss
    → the rows Adagrad tail (``ops/tail.py::rows_tail_adagrad_update``: sort
    and kernel, dedup included), in place.  On a CUDA state the tail is the kernel
    ``csrc/rows_tail_adagrad.cu``; on a CPU state its plain twin.  ``decay``
    is ``[Online] adagrad_decay`` γ (lazy touched-row decay)."""
    if state.layout != "rows":
        raise ValueError(f"train_step_body takes a rows-layout state, got {state.layout} "
                         "(packed_train_step_body steps the fused layout)")
    data_loss, g_rows, g_dense = _grads(model, state.table[batch.ids], state, batch)
    rows_tail_adagrad_update(
        state.table, state.table_accum, batch.ids, g_rows, learning_rate, decay=decay
    )
    return _finish(learning_rate, state, g_dense, decay), data_loss


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
    """Returns ``predict(state, batch) -> sigmoid scores [B]`` on the batch's
    device, for a rows-layout state."""
    return _predict_step(model, lambda table, ids: table[ids])  # plain indexing, as in XLA


def _predict_step(model, gather):
    @torch.inference_mode()
    def predict(state: TrainState, batch: Batch) -> torch.Tensor:
        rows = gather(state.table, batch.ids)
        return torch.sigmoid(model.score(rows, state.dense, batch))

    return predict


# --- lane-packed layouts (ops/packed_table.py) ----------------------------


def pack_state(
    state: TrainState, init_accumulator_value: float = 0.1, fused: bool = False
) -> TrainState:
    """Lane-pack a logical (rows-layout) state; the logical table is dropped
    once packed.  ``fused=True`` (``adagrad_accumulator = fused``) stores the
    [V, 1] row accumulator in each row's own slot.  Otherwise the table is
    packed for scoring, which reads no accumulator: packing the [V, D] or
    [V, 1] accumulator apart from the table belongs to the packed
    element/row tails, a later slice of the port."""
    if state.layout != "rows":
        raise ValueError(f"pack_state takes a rows-layout state, got {state.layout}")
    if fused:
        if state.table_accum is None or state.table_accum.shape[-1] != 1:
            raise ValueError("the fused layout packs a [V, 1] row accumulator")
        table = pack_fused(state.table, state.table_accum, init_accumulator_value)
        return dataclasses.replace(state, table=table, table_accum=None, layout="fused")
    if state.table_accum is not None:
        raise ValueError(
            "table_layout = packed with adagrad_accumulator = element | row is "
            "not ported yet for train (a later slice of fast_tffm_tpu_torch); "
            "use adagrad_accumulator = fused"
        )
    return dataclasses.replace(state, table=pack_table(state.table), layout="packed")


def unpack_state(state: TrainState, model) -> TrainState:
    """The logical arrays of a fused state, as checkpoints hold them: a
    [V, D] table and a [V, 1] accumulator (the JAX package's ``saveable``),
    one copy of the used lanes.  A rows-layout state comes back as it is."""
    if state.layout == "rows":
        return state
    if state.layout != "fused":
        raise ValueError("a packed scoring state carries no accumulator to save")
    table, accum = unpack_fused(state.table, model.vocabulary_size, model.row_dim)
    return dataclasses.replace(state, table=table, table_accum=accum, layout="rows")


def init_packed_state(
    model, generator: torch.Generator, init_accumulator_value: float = 0.1
) -> TrainState:
    """``init_state`` with a row accumulator, packed fused: the same logical
    draw, so a fused run starts from the parameters a rows run with the same
    generator would.  (The JAX function also packs the element and row
    accumulators apart from the table; those layouts train in a later
    slice of the port.)"""
    return pack_state(
        init_state(model, generator, init_accumulator_value, "row"),
        init_accumulator_value,
        fused=True,
    )


def packed_train_step_body(
    model, learning_rate: float, state: TrainState, batch: Batch, compact_cap: int = 0
):
    """The single-device step on a fused state: ``fused_gather`` → scorer →
    loss → sort → kernel B3 (``ops/tail.py::fused_tail_adagrad_update``,
    ``csrc/fused_tail_adagrad.cu`` on a CUDA state, its plain twin on a CPU
    one), in place.  ``compact_cap`` (``packed_compact_cap``) is the tail's
    ``k_cap``.

    The JAX body also takes ``update`` (``packed_update``) and ``tail``,
    which pick among its compiler paths for the same function (the dense
    and compact XLA tails, the Pallas kernel); the port has the one tail."""
    if state.layout != "fused":
        raise ValueError(
            f"packed_train_step_body steps a fused state, got {state.layout} (the "
            "packed element/row tails are a later slice of fast_tffm_tpu_torch)"
        )
    d = model.row_dim
    rows = fused_gather(state.table, batch.ids, d)
    data_loss, g_rows, g_dense = _grads(model, rows, state, batch)
    fused_tail_adagrad_update(state.table, batch.ids, g_rows, learning_rate, k_cap=compact_cap)
    return _finish(learning_rate, state, g_dense), data_loss


def make_packed_train_step(model, learning_rate: float, compact_cap: int = 0):
    """``make_train_step`` for a fused state (``packed_train_step_body``)."""
    return make_train_step(
        model, learning_rate,
        body=lambda mdl, lr, st, b: packed_train_step_body(mdl, lr, st, b, compact_cap),
    )


def make_packed_predict_step(model, fused: bool = False):
    """The predict step of a packed state: ``fused`` selects the fused
    layout's gather, else the packed one."""
    d = model.row_dim
    gather = fused_gather if fused else packed_gather
    return _predict_step(model, lambda table, ids: gather(table, ids, d))
