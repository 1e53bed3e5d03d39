"""Adagrad with a sparse, dedup-first update path — the counterpart of
``fast_tffm_tpu/optim.py``.

TF-Adagrad semantics, as in the JAX package:

    accum += g²          (accum initialized to init_accumulator_value)
    param -= lr * g / sqrt(accum)

Gradients arrive per gathered occurrence ``[B, N, D]``; occurrences of one
row id are summed first (``dedup_rows``: stable sort + segment sum, torch
ops, as the JAX package keeps it XLA outside its Pallas tail), then each
unique row is read and written once.  The accumulator's trailing dim picks
the granularity: ``[V, D]`` element (TF parity) or ``[V, 1]`` row
(``accum += ‖g_row‖²``).

The JAX package's arrays are immutable and its step donates the state so
XLA updates in place; here ``sparse_adagrad_update`` and
``dense_adagrad_update`` update their tensors **in place** — the port's
counterpart of donation — and return them.  ``sparse_adagrad_update`` is
the plain twin of the rows Adagrad kernel (``ops/tail.py``,
``csrc/rows_tail_adagrad.cu``): the kernel sums each id's occurrences in
``sorted_segment_sum``'s order and updates with ``adagrad_rows_plain``'s
expressions in their order.
"""

from __future__ import annotations

import torch

__all__ = [
    "init_table_adagrad",
    "accum_sq",
    "dedup_rows",
    "sorted_segment_sum",
    "rows_in_range",
    "adagrad_rows_plain",
    "sparse_adagrad_update",
    "dense_adagrad_update",
]


def init_table_adagrad(
    table: torch.Tensor, init_accumulator_value: float, accumulator: str = "element"
) -> torch.Tensor:
    """Accumulator for the sparse table: ``element`` ([V, D], TF parity) or
    ``row`` ([V, 1], grouped accumulator).  ``fused`` is a packed-layout
    storage choice, a later slice of the port."""
    if accumulator == "row":
        return torch.full(
            (table.shape[0], 1), init_accumulator_value, dtype=table.dtype, device=table.device
        )
    if accumulator != "element":
        raise ValueError(f"unknown adagrad accumulator {accumulator!r} (element | row)")
    return torch.full_like(table, init_accumulator_value)


def accum_sq(accum: torch.Tensor, gsum: torch.Tensor) -> torch.Tensor:
    """g² in the granularity the accumulator's shape declares.  Row mode
    sums ‖g‖² over the row left to right, in the kernel's order, so the
    kernel matches this twin bit for bit (``torch.sum`` reduces in an
    order of its own)."""
    sq = gsum * gsum
    if accum.shape[-1] == 1 and gsum.shape[-1] != 1:  # row mode
        acc = sq[..., :1]
        for d in range(1, sq.shape[-1]):
            acc = acc + sq[..., d : d + 1]
        return acc
    return sq  # element mode


def dedup_rows(ids: torch.Tensor, row_grads: torch.Tensor):
    """Sum per-occurrence row gradients over duplicate ids.

    ids: [M] int row ids (flattened batch×nnz), may repeat; row_grads:
    [M, D].  Returns (uids [K] int32, ascending and unique; gsum [K, D]).

    Unlike the JAX version, which pads to M with the sentinel id V for a
    scatter with ``mode="drop"``, this returns exactly the K unique rows:
    torch has no dropping scatter.  The sum runs in a fixed order (see
    ``sorted_segment_sum``), so two runs on the same inputs give
    bit-identical sums (an unordered atomic ``index_add_`` would not).
    """
    sid, order = torch.sort(ids, stable=True)
    return sorted_segment_sum(sid, order, row_grads)


def sorted_segment_sum(sid: torch.Tensor, order: torch.Tensor, row_grads: torch.Tensor):
    """``dedup_rows`` after its sort: ``sid, order = torch.sort(ids,
    stable=True)``, ``row_grads`` [M, D] in occurrence order.  Each id's
    occurrences, in input order, are summed left to right starting from 0
    (``segment_reduce`` over the permuted rows) — the order the tail
    kernels (``ops/tail.py``) sum in, straight from the sort's output."""
    uids, counts = torch.unique_consecutive(sid, return_counts=True)
    gsum = torch.segment_reduce(row_grads[order], "sum", lengths=counts, axis=0, unsafe=True)
    return uids.to(torch.int32), gsum


def rows_in_range(uids: torch.Tensor, gsum: torch.Tensor, bound: int):
    """The deduped rows whose id lies in [0, ``bound``): the tail kernels
    skip the others and never write them."""
    keep = (uids >= 0) & (uids < bound)
    if bool(keep.all()):
        return uids, gsum
    return uids[keep], gsum[keep]


def adagrad_rows_plain(
    table: torch.Tensor,
    accum: torch.Tensor,
    uids: torch.Tensor,
    gsum: torch.Tensor,
    lr: float,
    decay: float = 1.0,
):
    """The update half of ``sparse_adagrad_update`` on deduped rows, in
    place: acc ← decay·acc + g² (row: ‖g‖²), w ← w − lr·g/√acc.  The update
    of ``csrc/rows_tail_adagrad.cu``, in its expressions and order; ids
    outside [0, V) are skipped, as the kernel skips them."""
    uids, gsum = rows_in_range(uids, gsum, table.shape[0])
    idx = uids.long()
    acc_prev = accum[idx]
    if decay != 1.0:
        acc_prev = decay * acc_prev
    acc_rows = acc_prev + accum_sq(accum, gsum)
    table[idx] = table[idx] - lr * gsum / torch.sqrt(acc_rows)
    accum[idx] = acc_rows
    return table, accum


def sparse_adagrad_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    decay: float = 1.0,
):
    """Sparse Adagrad step on a ``[V, D]`` table and its ``[V, A]``
    accumulator, in place; returns them.

    ids: [...] int ids; row_grads: [..., D] matching occurrence grads.
    Only the unique touched rows are read and written.  ``decay`` γ < 1
    decays the accumulator lazily — only the rows a step touches pay
    ``accum = γ·accum + g²`` (``[Online] adagrad_decay``)."""
    d = table.shape[-1]
    uids, gsum = dedup_rows(ids.reshape(-1), row_grads.reshape(-1, d))
    return adagrad_rows_plain(table, accum, uids, gsum, lr, decay)


def dense_adagrad_update(params, accums, grads, lr: float, decay: float = 1.0):
    """Plain Adagrad over lists of dense tensors (DeepFM's MLP head), in
    place: accum ← γ·accum + g², p ← p − lr·g/√accum."""
    for p, a, g in zip(params, accums, grads):
        if decay != 1.0:
            a.mul_(decay)
        a.add_(g * g)
        p.sub_(lr * g / torch.sqrt(a))
    return params, accums
