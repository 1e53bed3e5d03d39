"""Model state, the train steps and the predict steps — the counterpart of
``fast_tffm_tpu/trainer.py`` (single device; the rows layout, and the
lane-packed layout with an element, row or fused accumulator).

One step is gather → scorer (its backward a CUDA kernel at order ≥ 3) →
loss → sparse Adagrad (on a CUDA state: ``torch.sort`` of the ids, then one
CUDA kernel per layout that dedups and updates; on a CPU state: dedup, then
the plain update).  The JAX step is
one jitted program that donates the state; here the step runs eagerly and
updates the state's tensors in place, which is the port's counterpart of
donation: a step never copies the table.  ``make_scanned_train_step`` runs
K steps per call (``steps_per_call``): on a CUDA state one replay of a
CUDA graph of the K step bodies (``utils/step_graph.py``), the port's
counterpart of the JAX package's ``lax.scan`` in one dispatch.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch, logistic_loss
from fast_tffm_tpu_torch.ops.packed_table import (
    fused_gather,
    pack_accum_any,
    pack_fused,
    pack_table,
    packed_gather,
    unpack_accum_any,
    unpack_fused,
    unpack_table,
)
from fast_tffm_tpu_torch.ops.tail import (
    fused_tail_adagrad_update,
    rows_tail_adagrad_update,
)
from fast_tffm_tpu_torch.optim import dense_adagrad_update, init_table_adagrad
from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

__all__ = [
    "LAYOUTS",
    "TrainState",
    "init_state",
    "batch_loss",
    "train_step_body",
    "make_train_step",
    "k_step_loop",
    "make_scanned_train_step",
    "make_decayed_body",
    "make_pallas_tail_body",
    "make_accum_restart",
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
      (``ops/packed_table.pack_table``); ``table_accum`` [VP, 128]
      (element) or [VP, P] (row) for training, none for scoring;
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


def k_step_loop(model, learning_rate: float, body, batch_at):
    """``run(state, *inputs) -> (state, losses [K])``: ``body`` applied to
    ``batch_at(k, *inputs)`` for k = 0..K-1 in order, K the first input's
    leading dim; the plain loop that a CUDA graph captures."""

    def run(state: TrainState, *inputs):
        losses = []
        for i in range(inputs[0].shape[0]):
            state, loss = body(model, learning_rate, state, batch_at(i, *inputs))
            losses.append(loss)
        return state, torch.stack(losses)

    return run


def make_scanned_train_step(model, learning_rate: float, body=None):
    """Returns ``step(state, superbatch) -> (state, losses [K])``: K
    consecutive train steps per call, the counterpart of the JAX
    ``make_scanned_train_step``.  ``superbatch`` is a Batch whose fields
    carry a leading micro-step dim ([K, B], [K, B, N], …;
    ``Batch.stack_parsed``), K read from its shape, so one step serves the
    main groups and the epoch's short tail group.  The body (default
    ``train_step_body``; the fused layout takes ``packed_train_step_body``)
    is the K = 1 step's, applied to the same values in the same order, so
    the per-step losses and the final state are bitwise those of K
    sequential steps.

    On a CPU state the K steps are a plain loop.  On a CUDA state they are
    captured once per (K, layout) into a CUDA graph and replayed
    (``utils/step_graph.StepGraphs``, exposed as ``step.graphs``); the
    superbatch, on the host or the card, is copied into the graph's static
    input buffers.  ``step.last_batch()`` is the superbatch the last call
    trained on, as its steps read it (on the card: the graph's static
    buffers), until the next call."""
    graphs = StepGraphs(k_step_loop(model, learning_rate, body or train_step_body,
                                    batch_at=lambda i, *fields: Batch(*(f[i] for f in fields))))

    def step(state: TrainState, superbatch: Batch):
        return graphs(state, *(getattr(superbatch, f.name) for f in dataclasses.fields(Batch)))

    step.graphs = graphs
    step.last_batch = lambda: Batch(*graphs.last_inputs)
    return step


def make_decayed_body(decay: float = 1.0):
    """``train_step_body`` with ``[Online] adagrad_decay`` γ baked in."""
    return lambda model, learning_rate, state, batch: train_step_body(
        model, learning_rate, state, batch, decay
    )


# The JAX package's name for the body whose tail is its Pallas rows kernel;
# here every body's tail is the rows kernel already.
make_pallas_tail_body = make_decayed_body


def make_accum_restart(init_accumulator_value: float):
    """``reset(state) -> state``: every Adagrad accumulator filled with the
    init value, in place (``fill_`` on the live tensors) — ``[Online]
    accum_restart_steps``, the window restart that re-opens every row's
    step size at once on a moving distribution.  Exact for the rows layout
    and the packed element and row accumulators alike (packing pads them
    with the init value, so a full fill is the packed init state).  The
    fused layout keeps its accumulator inside the table (config.validate
    refuses the pair).  The tensors keep their storage, so a CUDA graph of
    K steps replays on the reset state: the fill writes the graph's own
    static state."""

    @torch.no_grad()
    def reset(state: TrainState) -> TrainState:
        if state.table_accum is None:
            raise ValueError(f"a {state.layout} state has no accumulator array to reset")
        state.table_accum.fill_(init_accumulator_value)
        for a in state.dense_accum:
            a.fill_(init_accumulator_value)
        return state

    return reset


def make_predict_step(model):
    """Returns ``predict(state, batch) -> sigmoid scores [B]`` on the batch's
    device, for a rows-layout state."""
    return _predict_step(model, lambda table, ids: table[ids])  # plain indexing, as in XLA


def rowwise_sigmoid(raw: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` of [B] raw scores, each row's value independent of
    the rows scored beside it.  On the CPU, ATen's vectorized loop and its
    scalar tail round differently, so a row's score would depend on its
    position in the batch (a serving flush, a replica's failover resend);
    the scores go through the vector path whole, padded to a multiple of
    64.  On the card every element runs the same code."""
    if raw.device.type != "cpu":
        return torch.sigmoid(raw)
    n = raw.shape[0]
    return torch.sigmoid(torch.nn.functional.pad(raw, (0, -n % 64)))[:n]


def _predict_step(model, gather):
    @torch.inference_mode()
    def predict(state: TrainState, batch: Batch) -> torch.Tensor:
        rows = gather(state.table, batch.ids)
        return rowwise_sigmoid(model.score(rows, state.dense, batch))

    return predict


# --- lane-packed layouts (ops/packed_table.py) ----------------------------


def pack_state(
    state: TrainState, init_accumulator_value: float = 0.1, fused: bool = False
) -> TrainState:
    """Lane-pack a logical (rows-layout) state; the logical arrays are
    dropped once packed.  ``fused=True`` (``adagrad_accumulator = fused``)
    stores the [V, 1] row accumulator in each row's own slot.  Otherwise
    the table packs to [VP, 128] and the accumulator, when the state has
    one, apart from it (``pack_accum_any``: [V, D] -> [VP, 128], [V, 1] ->
    [VP, P], pads ``init_accumulator_value``); a scoring state has none."""
    if state.layout != "rows":
        raise ValueError(f"pack_state takes a rows-layout state, got {state.layout}")
    if fused:
        if state.table_accum is None or state.table_accum.shape[-1] != 1:
            raise ValueError("the fused layout packs a [V, 1] row accumulator")
        table = pack_fused(state.table, state.table_accum, init_accumulator_value)
        return dataclasses.replace(state, table=table, table_accum=None, layout="fused")
    d = state.table.shape[-1]
    accum = state.table_accum
    if accum is not None:
        accum = pack_accum_any(accum, d, init_accumulator_value)
    return dataclasses.replace(state, table=pack_table(state.table), table_accum=accum,
                               layout="packed")


def unpack_state(state: TrainState, model) -> TrainState:
    """The logical arrays of a packed or fused training state, as
    checkpoints hold them: a [V, D] table and its [V, D] or [V, 1]
    accumulator (the JAX package's ``saveable``), one copy of the used
    lanes.  A rows-layout state comes back as it is."""
    if state.layout == "rows":
        return state
    v, d = model.vocabulary_size, model.row_dim
    if state.layout == "fused":
        table, accum = unpack_fused(state.table, v, d)
    elif state.table_accum is None:
        raise ValueError("a packed scoring state carries no accumulator to save")
    else:
        table, accum = unpack_table(state.table, v, d), unpack_accum_any(state.table_accum, v, d)
    return dataclasses.replace(state, table=table, table_accum=accum, layout="rows")


def init_packed_state(
    model,
    generator: torch.Generator,
    init_accumulator_value: float = 0.1,
    accumulator: str = "fused",
) -> TrainState:
    """``init_state`` packed: the same logical draw, so a packed run starts
    from the parameters a rows run with the same generator would.
    ``accumulator`` ``fused`` stores a row accumulator in the table's slots;
    ``element`` and ``row`` pack it apart ([VP, 128], [VP, P])."""
    fused = accumulator == "fused"
    return pack_state(
        init_state(model, generator, init_accumulator_value, "row" if fused else accumulator),
        init_accumulator_value,
        fused=fused,
    )


def packed_train_step_body(
    model, learning_rate: float, state: TrainState, batch: Batch, compact_cap: int = 0
):
    """The single-device step on a lane-packed state, in place:

    * ``fused``: ``fused_gather`` → scorer → loss → sort → kernel B3
      (``ops/tail.py::fused_tail_adagrad_update``); ``compact_cap``
      (``packed_compact_cap``) is the tail's ``k_cap``;
    * ``packed`` (element or row accumulator): ``packed_gather`` → scorer →
      loss → sort → kernel B4 at the packed address
      (``ops/tail.py::rows_tail_adagrad_update``, ``packed=True``).

    Each tail is its kernel on a CUDA state and its plain twin on a CPU
    one.  The JAX body also takes ``update`` (``packed_update``) and
    ``tail``, which pick among its compiler paths for the same function
    (the dense, compact and sorted XLA tails, the Pallas kernel); the port
    has one tail per layout."""
    d = model.row_dim
    if state.layout == "fused":
        rows = fused_gather(state.table, batch.ids, d)
    elif state.layout == "packed" and state.table_accum is not None:
        rows = packed_gather(state.table, batch.ids, d)
    else:
        raise ValueError(
            f"packed_train_step_body steps a fused or packed training state, got {state.layout}"
            + ("" if state.layout == "rows" else " without an accumulator")
        )
    data_loss, g_rows, g_dense = _grads(model, rows, state, batch)
    if state.layout == "fused":
        fused_tail_adagrad_update(state.table, batch.ids, g_rows, learning_rate,
                                  k_cap=compact_cap)
    else:
        rows_tail_adagrad_update(state.table, state.table_accum, batch.ids, g_rows,
                                 learning_rate, packed=True)
    return _finish(learning_rate, state, g_dense), data_loss


def make_packed_train_step(model, learning_rate: float, compact_cap: int = 0):
    """``make_train_step`` for a fused or packed state (``packed_train_step_body``)."""
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
