"""The mesh-sharded train and predict steps — the counterpart of
``fast_tffm_tpu/parallel/train_step.py``.

One rank runs one step body per micro-batch (the JAX ``shard_map`` body):

  gather:   its ``B / P`` rows' table rows through the row group
            (``embedding``: all-gather of ids + reduce-scatter of rows) or
            by all-to-all routing (``alltoall``);
  compute:  the scorer and the loss, whose weight denominator is the
            all-reduced sum of every rank's weights;
  combine:  the deduped row gradients all-gathered over the world, the
            dense gradients (DeepFM's MLP) and the loss all-reduced;
  update:   each row shard applies sparse Adagrad to its own rows in one
            launch of its layout's kernel (B4, B4 at the packed address,
            B3), in place.

At world size 1 the step IS the single-device step (``trainer``), so a
1 x 1 ``dist_train`` is bitwise ``train``.  ``steps_per_call`` K > 1 runs
K bodies per call: a loop on the CPU, one CUDA-graph replay on the card
(``trainer.make_scanned_train_step``), its collectives inside the graph.
Under ``lookup = alltoall`` with ``lookup_overflow = fallback`` the
overflow flags of a call's K steps are agreed before it: a group with none
replays the routed graph, a group with one runs its steps eagerly, each
overflowing step through the all-gather body (the JAX ``lax.cond``).

The state of a rank is a ``trainer.TrainState`` whose table is its row
shard; checkpoints hold the logical ``[V_pad, D]`` arrays whatever the
mesh (``gather_logical_state``).  A rank's batch holds only its own
``B / P`` rows (``training.dist_train``'s sharded stream, converted as a
single-device batch is, the packed wire included): the JAX package's
``make_global_batch`` / ``make_global_superbatch`` / ``WireGlobalConverter``
stitch per-process chunks into global arrays, and here nothing global is
ever assembled; the collectives see the rank-ordered concatenation.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.ops.packed_table import (
    fused_rows_per_tile,
    pack_accum_any,
    pack_fused,
    pack_table,
    rows_per_tile,
    unpack_accum_any,
    unpack_fused,
    unpack_table,
)
from fast_tffm_tpu_torch.optim import dense_adagrad_update
from fast_tffm_tpu_torch.parallel.alltoall import (
    capacity_for,
    overflow_flags,
    routed_gather,
    routed_update,
    routing_overflow,
)
from fast_tffm_tpu_torch.parallel.embedding import (
    fused_sharded_gather,
    fused_sharded_update,
    packed_sharded_dense_update,
    packed_sharded_gather,
    packed_sharded_update,
    sharded_gather,
    sharded_sparse_adagrad_update,
)
from fast_tffm_tpu_torch.parallel.mesh import (
    ROW_AXIS,
    Mesh,
    all_gather_cat,
    all_reduce_sum,
    pad_vocab,
)
from fast_tffm_tpu_torch.trainer import (
    TrainState,
    init_state,
    k_step_loop,
    make_decayed_body,
    make_packed_predict_step,
    make_predict_step,
    make_scanned_train_step,
    make_train_step,
    packed_train_step_body,
    rowwise_sigmoid,
)
from fast_tffm_tpu_torch.utils.step_graph import StepGraphs

__all__ = [
    "packed_shard_meta",
    "shard_meta",
    "shard_state",
    "init_sharded_state",
    "unpack_shard",
    "restore_orbax_shard",
    "local_row_shard",
    "gather_logical_state",
    "gather_touched_rows",
    "make_sharded_train_step",
    "make_sharded_predict_step",
]


def _layout(table_layout: str, accumulator: str) -> str:
    if table_layout != "packed":
        return "rows"
    return "fused" if accumulator == "fused" else "packed"


def packed_shard_meta(model, mesh: Mesh, fused: bool = False):
    """``(padded_model, shard_logical_rows, rows_per_tile)`` of the packed
    sharded layout: the vocabulary padded to a multiple of R·P, so each
    shard packs to whole tile rows (``fused``: the fused pack factor)."""
    p = fused_rows_per_tile(model.row_dim) if fused else rows_per_tile(model.row_dim)
    padded = pad_vocab(model.vocabulary_size, mesh.row * p)
    return (dataclasses.replace(model, vocabulary_size=padded), padded // mesh.row, p)


def shard_meta(model, mesh: Mesh, layout: str):
    """``(padded_model, shard_logical_rows)`` for a rows, packed or fused
    state: the rows layout pads the vocabulary to a multiple of R."""
    if layout == "rows":
        padded = pad_vocab(model.vocabulary_size, mesh.row)
        return dataclasses.replace(model, vocabulary_size=padded), padded // mesh.row
    padded, rows, _ = packed_shard_meta(model, mesh, fused=layout == "fused")
    return padded, rows


def shard_state(logical: TrainState, model, mesh: Mesh, init_accumulator_value: float,
                layout: str) -> TrainState:
    """This rank's shard of a logical (rows-layout) state, in ``layout``.
    The logical arrays are re-padded to the mesh's ``V_pad`` rows first:
    rows past the saved ones start at zero with ``init_accumulator_value``
    (padding rows are never indexed), rows past ``V_pad`` drop.  A 1 x 1
    rows-layout state is the logical state itself (no copy).  A scoring
    state (no accumulator) shards its table alone."""
    _, shard_rows = shard_meta(model, mesh, layout)
    v_pad = shard_rows * mesh.row
    arrays = [(logical.table, 0.0), (logical.table_accum, init_accumulator_value)]
    out = []
    for x, fill in arrays:
        if x is not None and x.shape[0] != v_pad:
            padded = x.new_full((v_pad, x.shape[1]), fill)
            padded[: min(x.shape[0], v_pad)] = x[:v_pad]
            x = padded
        if x is not None and mesh.row > 1:
            lo = mesh.row_index * shard_rows
            x = x[lo : lo + shard_rows].clone()
        out.append(x)
    table, accum = out
    return _to_layout(dataclasses.replace(logical, table=table, table_accum=accum,
                                          layout="rows"), layout, init_accumulator_value)


def _to_layout(state: TrainState, layout: str, init_accumulator_value: float) -> TrainState:
    """A rows-layout shard in ``layout`` (packed or fused pack it)."""
    table, accum = state.table, state.table_accum
    if layout == "fused":
        return dataclasses.replace(state, table=pack_fused(table, accum, init_accumulator_value),
                                   table_accum=None, layout="fused")
    if layout == "packed":
        return dataclasses.replace(
            state, table=pack_table(table), layout="packed",
            table_accum=None if accum is None else pack_accum_any(accum, table.shape[1],
                                                                  init_accumulator_value))
    return state


def init_sharded_state(model, mesh: Mesh, generator: torch.Generator,
                       init_accumulator_value: float = 0.1, accumulator: str = "element",
                       table_layout: str = "rows") -> TrainState:
    """``trainer.init_state`` of the unpadded model from ``generator`` (the
    same draw on every rank and the single-device draw), re-padded and cut
    to this rank's shard in its layout."""
    layout = _layout(table_layout, accumulator)
    logical = init_state(model, generator, init_accumulator_value,
                         "row" if layout == "fused" else accumulator)
    return shard_state(logical, model, mesh, init_accumulator_value, layout)


def restore_orbax_shard(path: str, model, mesh: Mesh, layout: str, device,
                        init_accumulator_value: float, *, accum_width: int | None, log=print):
    """This rank's shard of the orbax checkpoint ``path`` in ``layout``,
    reading only the chunks that overlap its rows (no host copy of the
    table).  The saved padded vocabulary must be the mesh's: a re-pad would
    need the whole table on one process (the JAX package's multi-host
    refusal)."""
    from fast_tffm_tpu_torch.checkpoint import orbax_table_shape, restore_rows

    _, shard_rows = shard_meta(model, mesh, layout)
    v_pad = shard_rows * mesh.row
    saved = tuple(orbax_table_shape(path))
    if saved != (v_pad, model.row_dim):
        raise RuntimeError(
            f"checkpoint {path!r} has table shape {saved} "
            f"but this mesh expects {(v_pad, model.row_dim)} — multi-host "
            "restore needs a matching padded vocab (same row-shard count), "
            "or a single-host re-pad pass first"
        )
    lo = mesh.row_index * shard_rows
    stats: dict = {}
    part = restore_rows(path, device, lo, lo + shard_rows, n_dense=len(model.dense_names),
                        accum_width=accum_width, stats=stats)
    table_chunks = [k for k in stats["chunks_read"] if k.startswith("table/")]
    log(f"restored rows [{lo}, {lo + shard_rows}) of {path}: table chunks "
        f"{table_chunks} from {len(stats['data_files'])} data file(s)")
    return _to_layout(part, layout, init_accumulator_value)


def local_row_shard(state: TrainState, model, mesh: Mesh):
    """This rank's share of a multi-process orbax save (``checkpoint.
    RowShard``): its logical rows, unpacked from its own layout on its own
    device, at their place in the ``[V_pad, D]`` table.  Of the replicas of
    a row shard, the data coordinate 0 writes it; no rank gathers."""
    from fast_tffm_tpu_torch.checkpoint import RowShard

    _, shard_rows = shard_meta(model, mesh, state.layout)
    table, accum = unpack_shard(state, model.row_dim, shard_rows)
    return RowShard(dataclasses.replace(state, table=table, table_accum=accum, layout="rows"),
                    offset=mesh.row_index * shard_rows, total=shard_rows * mesh.row,
                    writes_rows=mesh.data_index == 0)


def unpack_shard(state: TrainState, d: int, shard_rows: int):
    """The logical ``(table [shard_rows, D], accum)`` of a rank's shard."""
    if state.layout == "fused":
        return unpack_fused(state.table, shard_rows, d)
    if state.layout == "packed":
        return (unpack_table(state.table, shard_rows, d),
                unpack_accum_any(state.table_accum, shard_rows, d))
    return state.table, state.table_accum


def gather_logical_state(state: TrainState, model, mesh: Mesh) -> TrainState | None:
    """The logical ``[V_pad, D]`` state on rank 0, what its npz save writes;
    None on every other rank.  The ranks of data coordinate 0 all-gather
    their shards over their row group (every rank calls this at the same
    boundary).  The whole table passes through rank 0's device and host
    memory: the modest-table path, as the JAX package's replicate-to-
    process-0 npz save is."""
    _, shard_rows = shard_meta(model, mesh, state.layout)
    table, accum = unpack_shard(state, model.row_dim, shard_rows)
    if mesh.data_index != 0:
        return None
    if not mesh.one(ROW_AXIS):
        table = all_gather_cat(table, mesh.row_group, mesh.row)
        accum = all_gather_cat(accum, mesh.row_group, mesh.row)
    if mesh.rank != 0:
        return None
    return dataclasses.replace(state, table=table, table_accum=accum, layout="rows")


def gather_touched_rows(state: TrainState, bitmap: torch.Tensor, model, mesh: Mesh):
    """A delta checkpoint's rows across the mesh: ``(idx, table rows,
    accum rows)``, ``idx`` the sorted logical ids that any rank's
    ``bitmap`` marks (the bitmaps OR-ed over the world), the rows their
    logical table and accumulator rows on rank 0 (None elsewhere).  Each
    rank of data coordinate 0 gathers the ids its row shard owns from its
    own layout; the row group's parts, padded to the largest, meet on rank
    0 by one all-gather.  Every rank calls this at the same boundary."""
    from fast_tffm_tpu_torch.checkpoint_async import gather_rows

    touched = bitmap
    if not mesh.single:
        import torch.distributed as dist

        touched = bitmap.to(torch.uint8)
        dist.all_reduce(touched, op=dist.ReduceOp.MAX)
    idx = torch.nonzero(touched).reshape(-1)
    if mesh.data_index != 0:
        return idx, None, None
    _, shard_rows = shard_meta(model, mesh, state.layout)
    owner = torch.div(idx, shard_rows, rounding_mode="floor")
    mine = idx[owner == mesh.row_index] - mesh.row_index * shard_rows
    trows, arows = gather_rows(state, mine, model.row_dim)
    counts = torch.bincount(owner, minlength=mesh.row).tolist()
    cap = max(counts)
    if not mesh.one(ROW_AXIS) and cap:
        pad = cap - trows.shape[0]
        trows = all_gather_cat(torch.nn.functional.pad(trows, (0, 0, 0, pad)), mesh.row_group,
                               mesh.row)
        arows = all_gather_cat(torch.nn.functional.pad(arows, (0, 0, 0, pad)), mesh.row_group,
                               mesh.row)
        keep = torch.cat([torch.arange(r * cap, r * cap + c, device=trows.device)
                          for r, c in enumerate(counts)])
        trows, arows = trows[keep], arows[keep]
    if mesh.rank != 0:
        return idx, None, None
    return idx, trows, arows


def _sharded_grads(model, rows, state: TrainState, batch: Batch, mesh: Mesh):
    """Data loss and the gradients of the total loss with respect to the
    gathered rows and the dense leaves, the loss's weight denominator
    being the all-reduced sum of every rank's weights."""
    denom = torch.clamp_min(all_reduce_sum(torch.sum(batch.weights), mesh.size), 1.0)
    rows = rows.detach().requires_grad_(True)
    dense = [p.detach().requires_grad_(True) for p in state.dense]
    scores = model.score(rows, dense, batch)
    per = (torch.clamp_min(scores, 0.0) - scores * batch.labels
           + torch.log1p(torch.exp(-torch.abs(scores))))
    data_loss = torch.sum(per * batch.weights) / denom
    total = data_loss + model.regularization(rows, dense, batch)
    g_rows, *g_dense = torch.autograd.grad(total, [rows, *dense])
    return data_loss.detach(), g_rows, g_dense


def _combine_dense(state: TrainState, g_dense, lr: float, mesh: Mesh, decay: float) -> None:
    if not state.dense:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in g_dense]), mesh.size)
    parts = torch.split(flat, [g.numel() for g in g_dense])
    grads = [p.view_as(g) for p, g in zip(parts, g_dense)]
    dense_adagrad_update(state.dense, state.dense_accum, grads, lr, decay)


class _Geometry:
    """What every body of one configuration shares."""

    def __init__(self, model, mesh: Mesh, layout: str, capacity_factor: float,
                 packed_update: str, compact_cap: int, decay: float):
        self.padded, self.shard_rows = shard_meta(model, mesh, layout)
        self.mesh, self.layout = mesh, layout
        self.capacity_factor = capacity_factor
        self.packed_update, self.compact_cap, self.decay = packed_update, compact_cap, decay
        self.d = model.row_dim

    def capacity(self, ids_shape) -> int:
        b, n = ids_shape[-2], ids_shape[-1]
        return capacity_for(b * n, self.mesh.row, self.capacity_factor)

    def can_overflow(self, ids_shape) -> bool:
        return self.capacity(ids_shape) < ids_shape[-2] * ids_shape[-1]

    def gather(self, table, ids):
        if self.layout == "fused":
            return fused_sharded_gather(table, ids, self.d, self.shard_rows, self.mesh)
        if self.layout == "packed":
            return packed_sharded_gather(table, ids, self.d, self.shard_rows, self.mesh)
        return sharded_gather(table, ids, self.mesh)

    def routed_gather(self, table, ids):
        packed = self.layout != "rows"
        return routed_gather(table, ids, self.capacity(ids.shape), self.mesh,
                             d=self.d if packed else None,
                             shard_logical_rows=self.shard_rows if packed else None,
                             fused=self.layout == "fused")


def _allgather_body(model, lr: float, geo: _Geometry):
    mesh, nrows = geo.mesh, geo.padded.vocabulary_size

    def body(_model, _lr, state: TrainState, batch: Batch):
        rows = geo.gather(state.table, batch.ids)
        data_loss, g_rows, g_dense = _sharded_grads(model, rows, state, batch, mesh)
        if geo.layout == "fused":
            fused_sharded_update(state.table, batch.ids, g_rows, lr, geo.shard_rows, mesh,
                                 k_cap=geo.compact_cap)
        elif geo.layout == "packed" and geo.packed_update == "sorted":
            packed_sharded_update(state.table, state.table_accum, batch.ids, g_rows, lr, nrows,
                                  geo.shard_rows, mesh)
        elif geo.layout == "packed":
            packed_sharded_dense_update(state.table, state.table_accum, batch.ids, g_rows, lr,
                                        geo.shard_rows, mesh)
        else:
            sharded_sparse_adagrad_update(state.table, state.table_accum, batch.ids, g_rows, lr,
                                          nrows, mesh, decay=geo.decay)
        return _finish(state, g_dense, data_loss, lr, geo)

    return body


def _routed_body(model, lr: float, geo: _Geometry, abort: bool):
    mesh, nrows = geo.mesh, geo.padded.vocabulary_size

    def body(_model, _lr, state: TrainState, batch: Batch):
        rows = geo.routed_gather(state.table, batch.ids)
        data_loss, g_rows, g_dense = _sharded_grads(model, rows, state, batch, mesh)
        _, _, overflow = routed_update(
            state.table, state.table_accum, batch.ids, g_rows, lr, nrows,
            geo.capacity(batch.ids.shape), mesh, shard_logical_rows=geo.shard_rows,
            layout=geo.layout, compact_cap=geo.compact_cap, decay=geo.decay)
        if abort:
            # A dropped contribution must never persist silently: the loss
            # goes NaN and the run stops before its next save.
            data_loss = torch.where(overflow, torch.full_like(data_loss, float("nan")),
                                    data_loss)
        return _finish(state, g_dense, data_loss, lr, geo)

    return body


def _finish(state: TrainState, g_dense, data_loss, lr: float, geo: _Geometry):
    _combine_dense(state, g_dense, lr, geo.mesh, geo.decay)
    state.step += 1
    return state, all_reduce_sum(data_loss, geo.mesh.size)


def _single_body(table_layout: str, compact_cap: int, decay: float):
    """The single-device body of the layout (``train``'s)."""
    if table_layout == "packed":
        return lambda mdl, lr, st, b: packed_train_step_body(mdl, lr, st, b, compact_cap)
    return make_decayed_body(decay)


def make_sharded_train_step(
    model, learning_rate: float, mesh: Mesh, *, lookup: str = "allgather",
    capacity_factor: float = 2.0, overflow_mode: str = "abort", table_layout: str = "rows",
    packed_update: str = "auto", accumulator: str = "element", compact_cap: int = 0,
    steps_per_call: int = 1, adagrad_decay: float = 1.0, source=None,
):
    """Returns ``step(state, batch) -> (state, loss)``, ``loss`` the global
    mean data loss (all-reduced: the same on every rank); with
    ``steps_per_call`` > 1 ``step(state, superbatch) -> (state, losses [K])``.
    ``batch`` holds this rank's rows.  ``lookup``: ``allgather`` or
    ``alltoall`` for both directions.  ``overflow_mode`` (alltoall):
    ``abort`` NaN-poisons an overflowing step's loss, ``fallback`` runs it
    through the all-gather body; ``step.overflow_steps`` counts the steps
    that fell back (the JAX step returns the flag instead).  The state's
    tensors update in place.

    ``source(i) -> Batch`` (the resident epoch's gather,
    ``data/device_cache.py``) makes the step take a 0-d device batch index
    ``i`` instead of a batch, and at K > 1 a [K] index vector, the gathers
    then inside the K-step graph."""
    layout = _layout(table_layout, accumulator)
    if accumulator == "fused" and table_layout != "packed":
        raise ValueError("accumulator='fused' requires table_layout='packed'")
    if lookup not in ("allgather", "alltoall"):
        raise ValueError(f"unknown lookup {lookup!r} (allgather | alltoall)")
    if overflow_mode not in ("abort", "fallback"):
        raise ValueError(f"unknown overflow_mode {overflow_mode!r} (abort | fallback)")
    decay = float(adagrad_decay)
    if decay != 1.0 and layout != "rows":
        raise ValueError(
            "adagrad_decay != 1.0 requires table_layout = rows (the packed tile-row "
            "updates rely on the zero-grad accumulator identity)")
    k = int(steps_per_call)
    if mesh.single:
        body = _single_body(table_layout, compact_cap, decay)
        if source is not None:
            step = _indexed_step(model, learning_rate, body, source, k)
        else:
            step = (make_scanned_train_step if k > 1 else make_train_step)(
                model, learning_rate, body=body)
        step.overflow_steps = 0
        return step
    geo = _Geometry(model, mesh, layout, capacity_factor, packed_update, compact_cap, decay)
    gather_body = _allgather_body(model, learning_rate, geo)
    if lookup == "allgather":
        main_body = gather_body
    else:
        main_body = _routed_body(model, learning_rate, geo, abort=overflow_mode == "abort")
    fallback = lookup == "alltoall" and overflow_mode == "fallback"
    if k > 1:
        if source is not None:
            scanned = _indexed_step(model, learning_rate, main_body, source, k)
            batch_at = lambda inputs, i: source(inputs[0][i])  # noqa: E731
        else:
            scanned = make_scanned_train_step(model, learning_rate, body=main_body)
            batch_at = lambda inputs, i: Batch(*(f[i] for f in inputs))  # noqa: E731
        last = {}

        def step(state: TrainState, superbatch):
            last.clear()
            if fallback:
                if source is not None:
                    inputs = (superbatch,)
                    ids = torch.stack([source(i).ids for i in superbatch])
                else:
                    dev = state.table.device
                    inputs = [getattr(superbatch, f.name).to(dev)
                              for f in dataclasses.fields(Batch)]
                    ids = inputs[1]
                flags = (overflow_flags(ids, geo.shard_rows, geo.capacity(ids.shape), mesh)
                         if geo.can_overflow(ids.shape) else [])
                if any(flags):
                    # A graph cannot branch on data: this group runs eagerly.
                    step.overflow_steps += sum(flags)
                    if source is None:
                        last["batch"] = Batch(*inputs)
                    losses = []
                    for i, flag in enumerate(flags):
                        state, loss = (gather_body if flag else main_body)(
                            model, learning_rate, state, batch_at(inputs, i))
                        losses.append(loss)
                    return state, torch.stack(losses)
            return scanned(state, superbatch)

        step.graphs = scanned.graphs
        if source is None:
            step.last_batch = lambda: last.get("batch") or scanned.last_batch()
    else:

        def step(state: TrainState, batch):
            if source is not None:
                batch = source(batch)
            if fallback and geo.can_overflow(batch.ids.shape) and routing_overflow(
                    batch.ids, geo.shard_rows, geo.capacity(batch.ids.shape), mesh):
                step.overflow_steps += 1
                return gather_body(model, learning_rate, state, batch)
            return main_body(model, learning_rate, state, batch)

    step.overflow_steps = 0
    return step


def _indexed_step(model, learning_rate: float, body, source, k: int):
    """``body`` on ``source(i)``: ``step(state, i)`` at K = 1, and at K > 1
    ``step(state, idxs [K])`` as one ``StepGraphs`` (the gathers inside the
    graph), exposed as ``step.graphs``."""
    if k <= 1:
        return lambda state, i: body(model, learning_rate, state, source(i))
    graphs = StepGraphs(k_step_loop(model, learning_rate, body,
                                    batch_at=lambda j, idxs: source(idxs[j])))

    def step(state: TrainState, idxs):
        return graphs(state, idxs)

    step.graphs = graphs
    return step


def make_sharded_predict_step(
    model, mesh: Mesh, *, lookup: str = "allgather", capacity_factor: float = 2.0,
    overflow_mode: str = "abort", table_layout: str = "rows", accumulator: str = "element",
):
    """Returns ``predict(state, batch) -> sigmoid scores [B]`` of the GLOBAL
    batch (every rank's scores all-gathered in rank order, so each rank
    holds them all); ``batch`` holds this rank's rows.  ``overflow_mode =
    fallback`` (alltoall) scores an overflowing batch through the
    all-gather lookup instead of NaN rows.  1 x 1: the single-device step."""
    layout = _layout(table_layout, accumulator)
    if mesh.single:
        if layout == "rows":
            return make_predict_step(model)
        return make_packed_predict_step(model, fused=layout == "fused")
    geo = _Geometry(model, mesh, layout, capacity_factor, "auto", 0, 1.0)
    fallback = lookup == "alltoall" and overflow_mode == "fallback"

    @torch.inference_mode()
    def predict(state: TrainState, batch: Batch) -> torch.Tensor:
        routed = lookup == "alltoall"
        if routed and fallback and geo.can_overflow(batch.ids.shape):
            routed = not routing_overflow(batch.ids, geo.shard_rows,
                                          geo.capacity(batch.ids.shape), mesh)
        rows = (geo.routed_gather if routed else geo.gather)(state.table, batch.ids)
        scores = rowwise_sigmoid(model.score(rows, state.dense, batch))
        return all_gather_cat(scores, None, mesh.size)

    return predict
