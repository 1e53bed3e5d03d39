"""The rows-layout sparse Adagrad tail: the CUDA kernel's wrapper.

Replaces ``fast_tffm_tpu/ops/pallas_tail.py::rows_tail_adagrad_update``
(``pallas_call`` → ``_rows_kernel``): the same dedup (``optim.dedup_rows``,
torch ops), then one kernel pass over the K unique rows that applies
``acc ← γ·acc + g²`` (row accumulator: ``‖g‖²``) and ``w ← w − lr·g/√acc``
in place on a ``[V, D]`` table and its ``[V, A]`` accumulator, A ∈ {1, D}.
The kernel is ``csrc/rows_tail_adagrad.cu``, built for ``sm_90a`` by
ops/kernel_build.py at first use and called through ctypes on PyTorch's
current stream.  (The fused-layout entry of that module,
``fused_tail_adagrad_update``, needs the packed layouts: a later slice.)

  rows_tail_adagrad_update(table, accum, ids, row_grads, lr, *, decay)
      dedup + update, in place; returns (table, accum)
  rows_tail_apply(table, accum, uids, gsum, lr, *, decay)
      the update alone on deduped rows (what the kernel computes)

On a CPU tensor the update is its plain twin, ``optim.adagrad_rows_plain``
(so ``rows_tail_adagrad_update`` is ``optim.sparse_adagrad_update``
there).  On a CUDA tensor it launches the kernel or raises.
``rows_tail_adagrad_update.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.optim import adagrad_rows_plain, dedup_rows

__all__ = ["rows_tail_adagrad_update", "rows_tail_apply"]


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
    for name, t, dtype in (
        ("table", table, torch.float32),
        ("accum", accum, torch.float32),
        ("uids", uids, torch.int32),
        ("gsum", gsum, torch.float32),
    ):
        if t.device != table.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"rows_tail_adagrad_update's kernel takes a contiguous {dtype} {name} "
                f"on {table.device}, got {t.dtype} on {t.device} contiguous={t.is_contiguous()}"
            )
    if k * d > 2**31 - 1:
        raise ValueError(f"rows_tail_adagrad_update: K·D = {k * d} exceeds int32")
    kernel = _kernel()
    if k == 0:
        return table, accum  # nothing to launch: an empty grid is an error
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = kernel(
            table.data_ptr(), accum.data_ptr(), uids.data_ptr(), gsum.data_ptr(),
            k, d, a, v, float(lr), float(decay), stream,
        )
    if rc != 0:
        raise RuntimeError(f"rows_tail_adagrad kernel launch failed with CUDA error {rc}")
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
