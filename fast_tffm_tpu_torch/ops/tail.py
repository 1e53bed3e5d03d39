"""The sparse Adagrad tails: the CUDA kernels' wrappers.

Replaces ``fast_tffm_tpu/ops/pallas_tail.py``, both of its entries.  Each
runs the same dedup (``optim.dedup_rows``, torch ops), then one kernel pass
over the K unique rows, in place:

* **rows layout** (``_rows_kernel``, ``csrc/rows_tail_adagrad.cu``):
  ``acc ← γ·acc + g²`` (row accumulator: ``‖g‖²``) and
  ``w ← w − lr·g/√acc`` on a ``[V, D]`` table and its ``[V, A]``
  accumulator, A ∈ {1, D};
* **fused layout** (``_fused_kernel``, ``csrc/fused_tail_adagrad.cu``):
  the row-accumulator update on the ``[VPf, 128]`` fused array
  (``ops/packed_table.py``), each row's accumulator in its own slot's
  lane D.

The kernels are built for ``sm_90a`` by ops/kernel_build.py at first use
and called through ctypes on PyTorch's current stream.

  rows_tail_adagrad_update(table, accum, ids, row_grads, lr, *, decay)
  rows_tail_apply(table, accum, uids, gsum, lr, *, decay)
  fused_tail_adagrad_update(fused, ids, row_grads, lr, *, decay, k_cap)
  fused_tail_apply(fused, uids, gsum, lr, *, decay)
      ``*_update``: dedup + update, in place; ``*_apply``: the update alone
      on deduped rows (what the kernel computes)

On a CPU tensor the update is its plain twin (``optim.adagrad_rows_plain``,
``fused_adagrad_plain``), so ``rows_tail_adagrad_update`` is
``optim.sparse_adagrad_update`` there.  On a CUDA tensor it launches the
kernel or raises.  ``<wrapper>_update.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.ops.packed_table import LANES, fused_rows_per_tile, fused_slots
from fast_tffm_tpu_torch.optim import accum_sq, adagrad_rows_plain, dedup_rows

__all__ = [
    "rows_tail_adagrad_update",
    "rows_tail_apply",
    "fused_tail_adagrad_update",
    "fused_tail_apply",
    "fused_adagrad_plain",
]


def _kernel():
    fn = kernel_build.load("rows_tail_adagrad").rows_tail_adagrad
    fn.argtypes = [
        ctypes.c_void_p,  # table
        ctypes.c_void_p,  # accum
        ctypes.c_void_p,  # uids (int32)
        ctypes.c_void_p,  # gsum
        ctypes.c_int,  # K
        ctypes.c_int,  # D
        ctypes.c_int,  # A
        ctypes.c_longlong,  # V
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
        ctypes.c_void_p,  # uids (int32)
        ctypes.c_void_p,  # gsum
        ctypes.c_int,  # K
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
    [0, V) are skipped by the kernel."""
    if table.device.type == "cpu":
        return adagrad_rows_plain(table, accum, uids, gsum, lr, decay)
    if table.device.type != "cuda":
        raise ValueError(f"rows_tail_adagrad_update takes cuda or cpu tensors, got {table.device}")
    v, d = table.shape
    k = uids.shape[0]
    a = accum.shape[-1]
    if accum.shape != (v, a) or a not in (1, d) or gsum.shape != (k, d) or uids.dim() != 1:
        raise ValueError(
            "rows_tail_adagrad_update's kernel takes table [V, D], accum [V, 1|D], "
            f"uids [K], gsum [K, D]; got {tuple(table.shape)}, {tuple(accum.shape)}, "
            f"{tuple(uids.shape)}, {tuple(gsum.shape)}"
        )
    _check_operands("rows_tail_adagrad_update", table.device, (
        ("table", table, torch.float32),
        ("accum", accum, torch.float32),
        ("uids", uids, torch.int32),
        ("gsum", gsum, torch.float32),
    ))
    if k * d > 2**31 - 1:
        raise ValueError(f"rows_tail_adagrad_update: K·D = {k * d} exceeds int32")
    kernel = _kernel()
    if k == 0:
        return table, accum  # nothing to launch: an empty grid is an error
    _launch(
        "rows_tail_adagrad", kernel, table.device,
        table.data_ptr(), accum.data_ptr(), uids.data_ptr(), gsum.data_ptr(),
        k, d, a, v, float(lr), float(decay),
    )
    rows_tail_adagrad_update.launches += 1
    return table, accum


def rows_tail_adagrad_update(
    table: torch.Tensor,
    accum: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    *,
    decay: float = 1.0,
):
    """``optim.sparse_adagrad_update`` with its update in one kernel pass:
    the same dedup, the same expressions, the same lazy γ decay; in place.
    ids: [...] int ids; row_grads: [..., D]."""
    d = table.shape[-1]
    uids, gsum = dedup_rows(ids.reshape(-1), row_grads.reshape(-1, d))
    return rows_tail_apply(table, accum, uids, gsum.contiguous(), lr, decay=decay)


rows_tail_adagrad_update.launches = 0


def fused_adagrad_plain(
    fused: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor, lr: float, decay: float = 1.0
) -> torch.Tensor:
    """The plain twin of ``csrc/fused_tail_adagrad.cu``: the expressions
    and order of ``optim.adagrad_rows_plain`` with a row accumulator,
    applied to each unique row's slot (its D parameters and its
    accumulator lane) through the ``[VPf, P, D+1]`` view, in place."""
    d = gsum.shape[-1]
    p = fused_rows_per_tile(d)
    idx = uids.long()
    phys, slot = idx // p, idx % p
    slots = fused_slots(fused, d)
    cur = slots[phys, slot]  # [K, D+1]
    acc_prev = cur[:, d:]
    if decay != 1.0:
        acc_prev = decay * acc_prev
    acc_rows = acc_prev + accum_sq(acc_prev, gsum)
    slots[phys, slot, :d] = cur[:, :d] - lr * gsum / torch.sqrt(acc_rows)
    slots[phys, slot, d:] = acc_rows
    return fused


def fused_tail_apply(
    fused: torch.Tensor, uids: torch.Tensor, gsum: torch.Tensor, lr: float, *, decay: float = 1.0
) -> torch.Tensor:
    """Row-Adagrad on the unique logical rows ``uids`` [K] with summed
    gradients ``gsum`` [K, D], in place on the fused array ``fused``
    [VPf, 128].  ``uids`` must be unique (``optim.dedup_rows`` output);
    ids outside [0, VPf·P) are skipped by the kernel."""
    if fused.device.type == "cpu":
        return fused_adagrad_plain(fused, uids, gsum, lr, decay)
    if fused.device.type != "cuda":
        raise ValueError(f"fused_tail_adagrad_update takes cuda or cpu tensors, got {fused.device}")
    k = uids.shape[0]
    d = gsum.shape[-1]
    if (
        fused.dim() != 2 or fused.shape[1] != LANES or uids.dim() != 1
        or gsum.shape != (k, d) or not 1 <= d < LANES
    ):
        raise ValueError(
            "fused_tail_adagrad_update's kernel takes fused [VPf, 128], uids [K], "
            f"gsum [K, D] with D + 1 <= 128; got {tuple(fused.shape)}, "
            f"{tuple(uids.shape)}, {tuple(gsum.shape)}"
        )
    _check_operands("fused_tail_adagrad_update", fused.device, (
        ("fused", fused, torch.float32),
        ("uids", uids, torch.int32),
        ("gsum", gsum, torch.float32),
    ))
    kernel = _fused_kernel()
    if k == 0:
        return fused  # nothing to launch: an empty grid is an error
    _launch(
        "fused_tail_adagrad", kernel, fused.device,
        fused.data_ptr(), uids.data_ptr(), gsum.data_ptr(),
        k, d, fused.shape[0], float(lr), float(decay),
    )
    fused_tail_adagrad_update.launches += 1
    return fused


def fused_tail_adagrad_update(
    fused: torch.Tensor,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    *,
    decay: float = 1.0,
    k_cap: int = 0,
) -> torch.Tensor:
    """Row-Adagrad over the fused ``[VPf, 128]`` layout in one kernel pass,
    in place: ``optim.dedup_rows``, then ``acc ← γ·acc + ‖g‖²``,
    ``w ← w − lr·g/√acc`` per unique logical row.  After unpacking, the
    result is bitwise ``optim.sparse_adagrad_update`` with a ``[V, 1]``
    accumulator on the logical arrays.

    ``k_cap`` (``packed_compact_cap``) is checked and passed through: the
    JAX tail caps its padded dedup span at ``k_cap`` rows and falls back to
    the full span when a batch touches more, but the port's dedup returns
    exactly the K unique rows, so both branches of that cap give what the
    kernel always computes."""
    if k_cap < 0:
        raise ValueError(f"k_cap must be >= 0, got {k_cap}")
    d = row_grads.shape[-1]
    uids, gsum = dedup_rows(ids.reshape(-1), row_grads.reshape(-1, d))
    return fused_tail_apply(fused, uids, gsum.contiguous(), lr, decay=decay)


fused_tail_adagrad_update.launches = 0
