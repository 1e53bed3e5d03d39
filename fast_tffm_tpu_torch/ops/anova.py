"""The ANOVA interaction sum: the CUDA kernels' wrappers and their plain twins.

Replaces ``fast_tffm_tpu/ops/pallas_anova.py::anova_inter``, a
``jax.custom_vjp`` whose forward is ``_fwd_impl`` → ``_fwd_kernel`` and
whose backward is ``_bwd_impl`` → ``_bwd_kernel``.  Here it is a
``torch.autograd.Function`` with the same split:

  anova_inter(z, order)            z [B, N, k] f32 → [B]:
                                   Σ_{m=2..order} Σ_f ANOVA_m(z[b, :, f]);
                                   differentiable in z
  anova_inter_bwd(z, g, order)     the backward alone: z̄ = g·∂out/∂z, [B, N, k]

On the card the forward is ``csrc/anova_fwd.cu`` and the backward
``csrc/anova_bwd.cu``, built for ``sm_90a`` by ops/kernel_build.py at first
use and called through ctypes on PyTorch's current stream.  On the CPU both
are their plain twins (``anova_inter_plain``, ``anova_inter_bwd_plain``).

A wrapper takes the plain version only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises: a missing ``nvcc``, a failed build,
an order the kernels were not instantiated for, a shape whose backward
carries do not fit in shared memory or a refused launch is an error, never a
silent switch to the plain version.  ``anova_inter.launches`` counts forward
kernel launches and ``anova_inter_bwd.launches`` backward ones (never
plain-version calls, nor the launches a CUDA-graph capture records).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fast_tffm_tpu_torch.ops import kernel_build

__all__ = [
    "anova_inter",
    "anova_inter_bwd",
    "anova_inter_plain",
    "anova_inter_bwd_plain",
    "MIN_ORDER",
    "MAX_ORDER",
]

# Orders instantiated as template arguments in csrc/anova_{fwd,bwd}.cu.
MIN_ORDER = 3
MAX_ORDER = 8
# The backward stashes N·(order−1) floats per thread in shared memory; a
# 32-thread block may use at most 227 KB (csrc/anova_bwd.cu).
_BWD_SMEM_LIMIT = 227 * 1024


def _shift_up(a: torch.Tensor) -> torch.Tensor:
    """shifted[m] = a[m−1], shifted[0] = 0 over the degree axis (dim 1)."""
    return F.pad(a[:, :-1, :], (0, 0, 1, 0))


def _carries(z: torch.Tensor, order: int):
    """The forward DP over features; yields the carry before each feature."""
    B, N, k = z.shape
    a = z.new_zeros((B, order + 1, k))
    a[:, 0, :] = 1.0
    for j in range(N):
        yield a
        a = a + z[:, j, None, :] * _shift_up(a)
    yield a


def anova_inter_plain(z: torch.Tensor, order: int) -> torch.Tensor:
    """The DP in torch: ``fast_tffm_tpu/ops/fm.py::_anova_scan_fwd`` summed
    over degrees 2..order.  One step per feature raises every degree at
    once: a[m] ← a[m] + z_j·a[m−1]."""
    *_, a = _carries(z, order)
    return torch.sum(a[:, 2:, :], dim=(1, 2))


def anova_inter_bwd_plain(z: torch.Tensor, g: torch.Tensor, order: int) -> torch.Tensor:
    """The reverse DP of ``fast_tffm_tpu/ops/fm.py::_fm_score_anova_bwd``:
    from the last feature down, z̄_j = Σ_m ā[m]·a_prev_j[m−1] and
    ā ← ā + shift_down(ā)·z_j, seeded with ā[2..order] = g."""
    B, N, k = z.shape
    prevs = list(_carries(z, order))[:-1]
    abar = z.new_zeros((B, order + 1, k))
    abar[:, 2:, :] = g[:, None, None]
    zbar = torch.empty_like(z)
    for j in range(N - 1, -1, -1):
        zbar[:, j, :] = torch.sum(abar * _shift_up(prevs[j]), dim=1)
        down = F.pad(abar[:, 1:, :], (0, 0, 0, 1))  # down[m] = ā[m+1], down[order] = 0
        abar = abar + down * z[:, j, None, :]
    return zbar


def _lib_fn(name: str, argtypes):
    fn = getattr(kernel_build.load(name), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, order: int, *tensors) -> None:
    if not MIN_ORDER <= order <= MAX_ORDER:
        raise ValueError(
            f"{name} supports orders {MIN_ORDER}..{MAX_ORDER} (the orders "
            f"csrc/anova_fwd.cu and csrc/anova_bwd.cu instantiate), got {order}"
        )
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} takes cuda or cpu tensors, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name}'s kernel takes contiguous float32 tensors, got shape "
                f"{tuple(t.shape)} {t.dtype} contiguous={t.is_contiguous()}"
            )
        if max(t.shape, default=0) > 2**31 - 1:
            raise ValueError(f"{name}: dimension too large for int32: {tuple(t.shape)}")


def _fwd_cuda(z: torch.Tensor, order: int) -> torch.Tensor:
    kernel = _lib_fn("anova_fwd", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])
    B, N, K = z.shape
    out = torch.empty((B,), device=z.device, dtype=torch.float32)
    if B == 0 or K == 0:
        return out.zero_()  # nothing to launch: an empty grid is an error
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = kernel(z.data_ptr(), out.data_ptr(), B, N, K, order, stream)
    if rc != 0:
        raise RuntimeError(f"anova_fwd kernel launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        anova_inter.launches += 1
    return out


class _AnovaInter(torch.autograd.Function):
    """Forward kernel / plain forward; saves z; backward kernel / plain backward."""

    @staticmethod
    def forward(ctx, z, order):
        ctx.order = order
        ctx.save_for_backward(z)
        if z.device.type == "cpu":
            return anova_inter_plain(z, order)
        return _fwd_cuda(z, order)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return anova_inter_bwd(z, g.contiguous(), ctx.order), None


def anova_inter(z: torch.Tensor, order: int) -> torch.Tensor:
    """Σ_{m=2..order} Σ_f ANOVA_m(z[·, ·, f]) per example.  z: [B, N, k] f32 → [B].

    Differentiable in ``z``: its backward is ``anova_inter_bwd``.
    ``anova_inter.launches`` counts forward kernel launches.
    """
    if not MIN_ORDER <= order <= MAX_ORDER:
        raise ValueError(
            f"anova_inter supports orders {MIN_ORDER}..{MAX_ORDER} (the orders "
            f"csrc/anova_fwd.cu instantiates), got {order}"
        )
    if z.device.type == "cuda":
        if z.dim() != 3:
            raise ValueError(f"anova_inter's kernel takes [B, N, k], got {tuple(z.shape)}")
        _check_cuda("anova_inter", order, z)
        kernel_build.load("anova_fwd")  # a missing nvcc raises before any autograd state
    elif z.device.type != "cpu":
        raise ValueError(f"anova_inter takes cuda or cpu tensors, got {z.device}")
    return _AnovaInter.apply(z, order)


def anova_inter_bwd(z: torch.Tensor, g: torch.Tensor, order: int) -> torch.Tensor:
    """z̄ [B, N, k] = g[b]·∂anova_inter(z)[b]/∂z: the reverse DP.

    ``anova_inter_bwd.launches`` counts backward kernel launches.
    """
    if z.device.type == "cpu":
        return anova_inter_bwd_plain(z, g, order)
    if z.dim() != 3 or g.shape != z.shape[:1]:
        raise ValueError(
            f"anova_inter_bwd takes z [B, N, k] and g [B], got {tuple(z.shape)} "
            f"and {tuple(g.shape)}"
        )
    _check_cuda("anova_inter_bwd", order, z, g)
    B, N, K = z.shape
    if 32 * 4 * N * (order - 1) > _BWD_SMEM_LIMIT:
        raise ValueError(
            f"anova_inter_bwd: N={N} features at order {order} need "
            f"{4 * N * (order - 1)} bytes of shared memory per thread; a "
            f"32-thread block has at most {_BWD_SMEM_LIMIT}"
        )
    kernel = _lib_fn("anova_bwd", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])
    zbar = torch.empty_like(z)
    if B == 0 or K == 0 or N == 0:
        return zbar  # nothing to launch: an empty grid is an error
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = kernel(z.data_ptr(), g.data_ptr(), zbar.data_ptr(), B, N, K, order, stream)
    if rc != 0:
        raise RuntimeError(f"anova_bwd kernel launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        anova_inter_bwd.launches += 1
    return zbar


anova_inter.launches = 0
anova_inter_bwd.launches = 0
