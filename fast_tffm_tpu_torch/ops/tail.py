"""The sparse Adagrad tails: the CUDA kernels' wrappers.

Replaces ``fast_tffm_tpu/ops/pallas_tail.py``, both of its entries, and the
dedup before them.  On a CUDA state an update runs ``torch.sort`` of the
flat ids (which stays a torch call, as the JAX package leaves its sort to
XLA outside the pallas_call) and then ONE kernel launch on the sort's
output: the kernel finds each unique id's occurrences, sums their gradient
rows in ``optim.sorted_segment_sum``'s order and updates the row, in
place, with no host sync:

* **rows layout** (``_rows_kernel``, ``csrc/rows_tail_adagrad.cu``):
  ``acc ← γ·acc + g²`` (row accumulator: ``‖g‖²``) and
  ``w ← w − lr·g/√acc`` on a ``[V, D]`` table and its ``[V, A]``
  accumulator, A ∈ {1, D};
* **packed layout**, the same kernel at the packed address (P logical rows
  to a 128-float tile row, ``ops/packed_table.py``): the ``[VP, 128]``
  table with its ``[VP, 128]`` element or ``[VP, P]`` row accumulator.
  The JAX package updates this layout with XLA (no Pallas kernel); its
  sums and expressions are the rows layout's, so the port runs them in
  kernel B4;
* **fused layout** (``_fused_kernel``, ``csrc/fused_tail_adagrad.cu``):
  the row-accumulator update on the ``[VPf, 128]`` fused array
  (``ops/packed_table.py``), each row's accumulator in its own slot's
  lane D.

The kernels are built for ``sm_90a`` by ops/kernel_build.py at first use
and called through ctypes on PyTorch's current stream.

  rows_tail_adagrad_update(table, accum, ids, row_grads, lr, *, decay, packed)
  rows_tail_apply(table, accum, uids, gsum, lr, *, decay)
  fused_tail_adagrad_update(fused, ids, row_grads, lr, *, decay, k_cap)
  fused_tail_apply(fused, uids, gsum, lr, *, decay)
      ``*_update``: sort + kernel, in place; ``*_apply``: the same kernel on
      already-deduped rows (``order = arange(K)``)
  rows_tail_sorted(table, accum, sid, order, row_grads, lr, *, decay, packed)
  fused_tail_sorted(fused, sid, order, row_grads, lr, *, decay)
      the kernel alone, on the sort's output
  rows_tail_sorted_plain(table, accum, sid, order, row_grads, lr, decay, packed)
  fused_tail_sorted_plain(fused, sid, order, row_grads, lr, decay)
      the kernels' plain twins: ``optim.sorted_segment_sum``, then the
      plain update (``optim.adagrad_rows_plain``, its packed-layout form,
      ``fused_adagrad_plain``)

``rows_restored()`` is a block inside which every row these entries are
about to write (in this thread) is saved first and put back at its end:
the K-step graph's warm-up runs on the live state at the cost of the rows
its batches touch (``utils/step_graph.py``).

``packed=True`` takes the packed layout's ``[VP, 128]`` table and its
``[VP, 128]`` or ``[VP, P]`` accumulator; D is ``row_grads``' width.

On a CPU tensor each entry runs the twin, so ``rows_tail_adagrad_update``
is ``optim.sparse_adagrad_update`` there (the dedup is the sort plus
``sorted_segment_sum``) and ``*_apply`` is the plain update.  On a CUDA
tensor it launches the kernel or raises.  ``<wrapper>_update.launches``
counts kernel launches (not the launches a CUDA-graph capture records);
B4's count, ``rows_tail_adagrad_update.launches``, holds both layouts'.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.ops.packed_table import (
    LANES,
    fused_rows_per_tile,
    fused_slots,
    packed_slots,
    rows_per_tile,
)
from fast_tffm_tpu_torch.optim import (
    accum_sq,
    adagrad_rows_plain,
    rows_in_range,
    sorted_segment_sum,
    sqrt_rn,
)

__all__ = [
    "rows_tail_adagrad_update",
    "rows_tail_apply",
    "rows_tail_sorted",
    "rows_tail_sorted_plain",
    "fused_tail_adagrad_update",
    "fused_tail_apply",
    "fused_tail_sorted",
    "fused_tail_sorted_plain",
    "fused_adagrad_plain",
    "rows_restored",
]

_INT32_MAX = 2**31 - 1
_journal = threading.local()


@contextlib.contextmanager
def rows_restored():
    """Inside the block, each tail entry of this thread saves the rows
    (tile rows, on a packed or fused array) of its table and accumulator
    that it is about to write, once per row; at the end of the block,
    raised or not, the saved rows are written back on the current stream.
    The tensors come out of the block bitwise as they went in, at the cost
    of a copy of the touched rows."""
    if getattr(_journal, "entries", None) is not None:
        raise RuntimeError("rows_restored() blocks do not nest")
    _journal.entries = entries = []
    try:
        yield
    finally:
        _journal.entries = None
        for t, rows, saved in reversed(entries):
            t.index_copy_(0, rows, saved)


def _save_rows(tensors, ids: torch.Tensor, p: int) -> None:
    """Under ``rows_restored``: save the rows of ``tensors`` (dim 0) that the
    logical ``ids`` address at ``p`` logical rows per physical row, skipping
    rows out of range (the kernels skip them) and rows already saved."""
    entries = getattr(_journal, "entries", None)
    if entries is None:
        return
    rows = torch.unique(ids.reshape(-1).long() // p)
    for t in tensors:
        mine = rows[(rows >= 0) & (rows < t.shape[0])]
        earlier = [r for tt, r, _ in entries if tt is t]
        if earlier:
            mine = mine[~torch.isin(mine, torch.cat(earlier))]
        entries.append((t, mine, t.index_select(0, mine)))


def _kernel():
    fn = kernel_build.load("rows_tail_adagrad").rows_tail_adagrad
    fn.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_void_p,  # accum
        ctypes.c_void_p,  # sid (int32, sorted)
        ctypes.c_void_p,  # order (int64)
        ctypes.c_void_p,  # row_grads
        ctypes.c_int,  # M
        ctypes.c_int,  # D
        ctypes.c_int,  # A
        ctypes.c_longlong,  # V
        ctypes.c_int,  # P
        ctypes.c_int,  # pitch
        ctypes.c_float,  # lr
        ctypes.c_float,  # decay
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


def _fused_kernel():
    fn = kernel_build.load("fused_tail_adagrad").fused_tail_adagrad
    fn.argtypes = [
        ctypes.c_void_p,  # fused
        ctypes.c_void_p,  # sid (int32, sorted)
        ctypes.c_void_p,  # order (int64)
        ctypes.c_void_p,  # row_grads
        ctypes.c_int,  # M
        ctypes.c_int,  # D
        ctypes.c_longlong,  # VPf
        ctypes.c_float,  # lr
        ctypes.c_float,  # decay
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(who: str, device, operands) -> None:
    """Every ``(name, tensor, dtype)`` contiguous, of its dtype, on ``device``."""
    for name, t, dtype in operands:
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{who}'s kernel takes a contiguous {dtype} {name} on {device}, got "
                f"{t.dtype} on {t.device} contiguous={t.is_contiguous()}"
            )


def _launch(who: str, kernel, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = kernel(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed with CUDA error {rc}")


def _check_occurrences(who: str, device, sid, order, row_grads) -> tuple[int, int]:
    """The sorted occurrences a tail kernel takes (``order`` None: deduped
    rows, each its own segment); returns (M, D)."""
    m, d = row_grads.shape[0], row_grads.shape[-1]
    operands = [("sid", sid, torch.int32), ("row_grads", row_grads, torch.float32)]
    if order is not None:
        operands.append(("order", order, torch.int64))
    if sid.dim() != 1 or row_grads.shape != (sid.shape[0], d) or (
        order is not None and order.shape != sid.shape
    ):
        raise ValueError(
            f"{who}'s kernel takes sid [M], order [M], row_grads [M, D]; got "
            f"{tuple(sid.shape)}, {None if order is None else tuple(order.shape)}, "
            f"{tuple(row_grads.shape)}"
        )
    _check_operands(who, device, operands)
    if m * d > _INT32_MAX:
        raise ValueError(f"{who}: M·D = {m * d} exceeds int32")
    return m, d


def _packed_geometry(table, accum, d: int) -> tuple[int, int, int]:
    """(A, P, logical rows) of a packed ``[VP, 128]`` table with its
    ``[VP, 128]`` element or ``[VP, P]`` row accumulator (at D = 1 the two
    coincide, and so do their updates)."""
    p = rows_per_tile(d)
    vp = table.shape[0]
    if table.shape != (vp, LANES) or accum.shape not in ((vp, LANES), (vp, p)):
        raise ValueError(
            f"a packed tail takes table [VP, {LANES}] and accum [VP, {LANES}] (element) "
            f"or [VP, P={p}] (row); got {tuple(table.shape)}, {tuple(accum.shape)}"
        )
    return (d if accum.shape[-1] == LANES else 1), p, vp * p


def _rows_launch(table, accum, sid, order, row_grads, lr: float, decay: float,
                 packed: bool = False):
    """Kernel B4 on sorted occurrences (``order`` None: deduped rows), in
    place, on the rows layout or (``packed``) the packed one."""
    if table.device.type != "cuda":
        raise ValueError(f"rows_tail_adagrad_update takes cuda or cpu tensors, got {table.device}")
    d = row_grads.shape[-1]
    if packed:
        a, p, v = _packed_geometry(table, accum, d)
        pitch = LANES
    else:
        v, p, pitch = table.shape[0], 1, d
        a = accum.shape[-1]
        if table.shape != (v, d) or accum.shape != (v, a) or a not in (1, d) or d > 256:
            raise ValueError(
                "rows_tail_adagrad_update's kernel takes table [V, D] with D <= 256, accum "
                f"[V, 1|D], row_grads [M, D]; got {tuple(table.shape)}, {tuple(accum.shape)}, "
                f"{tuple(row_grads.shape)}"
            )
    _check_operands("rows_tail_adagrad_update", table.device, (
        ("table", table, torch.float32),
        ("accum", accum, torch.float32),
    ))
    m, _ = _check_occurrences("rows_tail_adagrad_update", table.device, sid, order, row_grads)
    kernel = _kernel()
    if m == 0:
        return table, accum  # nothing to launch: an empty grid is an error
    if order is None:
        order = torch.arange(m, device=sid.device)
    _launch(
        "rows_tail_adagrad", kernel, table.device,
        table.data_ptr(), accum.data_ptr(), sid.data_ptr(), order.data_ptr(),
        row_grads.data_ptr(), m, d, a, v, p, pitch, float(lr), float(decay),
    )
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        rows_tail_adagrad_update.launches += 1
    return table, accum


def rows_tail_sorted(table, accum, sid, order, row_grads, lr: float, *, decay: float = 1.0,
                     packed: bool = False):
    """Kernel B4 on its own input, the stable sort of the flat ids (``sid``
    int32, its permutation ``order`` int64) and ``row_grads`` [M, D] in
    occurrence order, in place, on the rows or (``packed``) the packed
    layout; on a CPU tensor its twin ``rows_tail_sorted_plain``."""
    _save_rows((table, accum), sid, rows_per_tile(row_grads.shape[-1]) if packed else 1)
    if table.device.type == "cpu":
        return rows_tail_sorted_plain(table, accum, sid, order, row_grads, lr, decay, packed)
    return _rows_launch(table, accum, sid, order, row_grads, lr, decay, packed)


def rows_tail_apply(
    table: torch.Tensor,
    accum: torch.Tensor,
    uids: torch.Tensor,
    gsum: torch.Tensor,
    lr: float,
    *,
    decay: float = 1.0,
):
    """Adagrad on the unique rows ``uids`` [K] with summed gradients
    ``gsum`` [K, D], in place on ``table`` [V, D] and ``accum`` [V, A].
    ``uids`` must be unique (``optim.dedup_rows`` output); ids outside
    [0, V) are skipped.  On the card: kernel B4 with ``order = arange(K)``,
    each row its own segment."""
    _save_rows((table, accum), uids, 1)
    if table.device.type == "cpu":
        return adagrad_rows_plain(table, accum, uids, gsum, lr, decay)
    return _rows_launch(table, accum, uids, None, gsum, lr, decay)


def rows_tail_adagrad_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    *,
    decay: float = 1.0,
    packed: bool = False,
):
    """``optim.sparse_adagrad_update`` as ``torch.sort`` plus one kernel
    pass: the same segment sums, the same expressions, the same lazy γ
    decay; in place, with no host sync.  ids: [...] int32 ids; row_grads:
    [..., D].  ``packed``: the table is the packed ``[VP, 128]`` one with
    its ``[VP, 128]`` element or ``[VP, P]`` row accumulator; after
    unpacking the result is bitwise the rows layout's on the logical
    arrays (the JAX package's packed tails hold the same sums in the same
    order)."""
    d = row_grads.shape[-1]
    sid, order = torch.sort(ids.reshape(-1), stable=True)
    return rows_tail_sorted(
        table, accum, sid, order, row_grads.reshape(-1, d).contiguous(), lr, decay=decay,
        packed=packed,
    )


rows_tail_adagrad_update.launches = 0


def _packed_adagrad_plain(
    packed: torch.Tensor,
    accum: torch.Tensor,
    uids: torch.Tensor,
    gsum: torch.Tensor,
    lr: float,
    decay: float = 1.0,
):
    """``optim.adagrad_rows_plain`` on the packed layout, in place: the same
    expressions in the same order on each unique logical row's D lanes
    (through the ``[VP, P, D]`` view) and its accumulator (the element
    accumulator's lanes, or the row accumulator's slot).  Ids outside
    [0, VP·P) are skipped, as the kernel skips them."""
    d = gsum.shape[-1]
    a, p, bound = _packed_geometry(packed, accum, d)
    uids, gsum = rows_in_range(uids, gsum, bound)
    idx = uids.long()
    phys, slot = idx // p, idx % p
    table_rows = packed_slots(packed, d)
    acc_rows = packed_slots(accum, d) if a == d else accum.view(-1, p, 1)
    acc_prev = acc_rows[phys, slot]
    if decay != 1.0:
        acc_prev = decay * acc_prev
    acc_new = acc_prev + accum_sq(acc_prev, gsum)
    table_rows[phys, slot] = table_rows[phys, slot] - lr * gsum / sqrt_rn(acc_new)
    acc_rows[phys, slot] = acc_new
    return packed, accum


def rows_tail_sorted_plain(table, accum, sid, order, row_grads, lr: float, decay: float = 1.0,
                           packed: bool = False):
    """The plain twin of ``csrc/rows_tail_adagrad.cu`` on the kernel's own
    input, the sort's output: ``optim.sorted_segment_sum``, then
    ``optim.adagrad_rows_plain`` (``packed``: its form on the packed
    layout); in place."""
    uids, gsum = sorted_segment_sum(sid, order, row_grads)
    update = _packed_adagrad_plain if packed else adagrad_rows_plain
    return update(table, accum, uids, gsum, lr, decay)


def fused_adagrad_plain(
    fused: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor, lr: float, decay: float = 1.0
) -> torch.Tensor:
    """The update of ``csrc/fused_tail_adagrad.cu`` on deduped rows: the
    expressions and order of ``optim.adagrad_rows_plain`` with a row
    accumulator, applied to each unique row's slot (its D parameters and its
    accumulator lane) through the ``[VPf, P, D+1]`` view, in place.  Ids
    outside [0, VPf·P) are skipped, as the kernel skips them."""
    d = gsum.shape[-1]
    p = fused_rows_per_tile(d)
    uids, gsum = rows_in_range(uids, gsum, fused.shape[0] * p)
    idx = uids.long()
    phys, slot = idx // p, idx % p
    slots = fused_slots(fused, d)
    cur = slots[phys, slot]  # [K, D+1]
    acc_prev = cur[:, d:]
    if decay != 1.0:
        acc_prev = decay * acc_prev
    acc_rows = acc_prev + accum_sq(acc_prev, gsum)
    slots[phys, slot, :d] = cur[:, :d] - lr * gsum / sqrt_rn(acc_rows)
    slots[phys, slot, d:] = acc_rows
    return fused


def fused_tail_sorted_plain(fused, sid, order, row_grads, lr: float, decay: float = 1.0):
    """The plain twin of ``csrc/fused_tail_adagrad.cu`` on the sort's
    output: ``optim.sorted_segment_sum``, then ``fused_adagrad_plain``."""
    uids, gsum = sorted_segment_sum(sid, order, row_grads)
    return fused_adagrad_plain(fused, uids, gsum, lr, decay)


def _fused_launch(fused, sid, order, row_grads, lr: float, decay: float):
    """Kernel B3 on sorted occurrences (``order`` None: deduped rows), in place."""
    if fused.device.type != "cuda":
        raise ValueError(f"fused_tail_adagrad_update takes cuda or cpu tensors, got {fused.device}")
    d = row_grads.shape[-1]
    if fused.dim() != 2 or fused.shape[1] != LANES or row_grads.dim() != 2 or not 1 <= d < LANES:
        raise ValueError(
            "fused_tail_adagrad_update's kernel takes fused [VPf, 128] and row_grads "
            f"[M, D] with D + 1 <= 128; got {tuple(fused.shape)}, {tuple(row_grads.shape)}"
        )
    _check_operands("fused_tail_adagrad_update", fused.device, (("fused", fused, torch.float32),))
    if fused.data_ptr() % 8:
        raise ValueError("fused_tail_adagrad_update's kernel takes an 8-byte aligned fused array")
    m, _ = _check_occurrences("fused_tail_adagrad_update", fused.device, sid, order, row_grads)
    kernel = _fused_kernel()
    if m == 0:
        return fused  # nothing to launch: an empty grid is an error
    if order is None:
        order = torch.arange(m, device=sid.device)
    _launch(
        "fused_tail_adagrad", kernel, fused.device,
        fused.data_ptr(), sid.data_ptr(), order.data_ptr(), row_grads.data_ptr(),
        m, d, fused.shape[0], float(lr), float(decay),
    )
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        fused_tail_adagrad_update.launches += 1
    return fused


def fused_tail_sorted(fused, sid, order, row_grads, lr: float, *, decay: float = 1.0):
    """Kernel B3 on its own input, the stable sort of the flat ids and the
    gradients in occurrence order, in place; on a CPU tensor its twin
    ``fused_tail_sorted_plain``."""
    _save_rows((fused,), sid, fused_rows_per_tile(row_grads.shape[-1]))
    if fused.device.type == "cpu":
        return fused_tail_sorted_plain(fused, sid, order, row_grads, lr, decay)
    return _fused_launch(fused, sid, order, row_grads, lr, decay)


def fused_tail_apply(
    fused: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor, lr: float, *, decay: float = 1.0
) -> torch.Tensor:
    """Row-Adagrad on the unique logical rows ``uids`` [K] with summed
    gradients ``gsum`` [K, D], in place on the fused array ``fused``
    [VPf, 128].  ``uids`` must be unique (``optim.dedup_rows`` output); ids
    outside [0, VPf·P) are skipped.  On the card: kernel B3 with
    ``order = arange(K)``."""
    _save_rows((fused,), uids, fused_rows_per_tile(gsum.shape[-1]))
    if fused.device.type == "cpu":
        return fused_adagrad_plain(fused, uids, gsum, lr, decay)
    return _fused_launch(fused, uids, None, gsum, lr, decay)


def fused_tail_adagrad_update(
    fused: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    *,
    decay: float = 1.0,
    k_cap: int = 0,
) -> torch.Tensor:
    """Row-Adagrad over the fused ``[VPf, 128]`` layout as ``torch.sort``
    plus one kernel pass, in place, with no host sync: per unique logical
    row, its occurrences' gradients summed in ``optim.dedup_rows``' order,
    ``acc ← γ·acc + ‖g‖²``, ``w ← w − lr·g/√acc``.  After unpacking, the
    result is bitwise ``optim.sparse_adagrad_update`` with a ``[V, 1]``
    accumulator on the logical arrays.

    ``k_cap`` (``packed_compact_cap``) is checked and passed through: the
    JAX tail caps its padded dedup span at ``k_cap`` rows and falls back to
    the full span when a batch touches more, but the port's kernel visits
    exactly the K unique rows, so both branches of that cap give what the
    kernel always computes."""
    if k_cap < 0:
        raise ValueError(f"k_cap must be >= 0, got {k_cap}")
    d = row_grads.shape[-1]
    sid, order = torch.sort(ids.reshape(-1), stable=True)
    return fused_tail_sorted(
        fused, sid, order, row_grads.reshape(-1, d).contiguous(), lr, decay=decay
    )


fused_tail_adagrad_update.launches = 0
