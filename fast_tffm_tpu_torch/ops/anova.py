"""The ANOVA interaction sum: the CUDA kernel's wrapper and its plain twin.

Replaces ``fast_tffm_tpu/ops/pallas_anova.py::anova_inter`` forward
(``_fwd_impl`` → ``_fwd_kernel``).  The kernel is ``csrc/anova_fwd.cu``,
built for ``sm_90a`` by ops/kernel_build.py at first use and called through
ctypes on PyTorch's current stream.

  anova_inter(z, order)        z [B, N, k] f32 → [B]:
                               Σ_{m=2..order} Σ_f ANOVA_m(z[b, :, f])

The wrapper takes the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises: a missing ``nvcc``, a failed
build, an order the kernel was not instantiated for or a refused launch is
an error, never a silent switch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fast_tffm_tpu_torch.ops import kernel_build

__all__ = ["anova_inter", "anova_inter_plain", "MIN_ORDER", "MAX_ORDER"]

# Orders instantiated as template arguments in csrc/anova_fwd.cu.
MIN_ORDER = 3
MAX_ORDER = 8


def anova_inter_plain(z: torch.Tensor, order: int) -> torch.Tensor:
    """The DP in torch: ``fast_tffm_tpu/ops/fm.py::_anova_scan_fwd`` summed
    over degrees 2..order.  One step per feature raises every degree at
    once: a[m] ← a[m] + z_j·a[m−1]."""
    B, N, k = z.shape
    a = z.new_zeros((B, order + 1, k))
    a[:, 0, :] = 1.0
    for j in range(N):
        shifted = F.pad(a[:, :-1, :], (0, 0, 1, 0))  # shifted[m] = a[m-1], shifted[0] = 0
        a = a + z[:, j, None, :] * shifted
    return torch.sum(a[:, 2:, :], dim=(1, 2))


def _kernel():
    fn = kernel_build.load("anova_fwd").anova_fwd
    fn.argtypes = [
        ctypes.c_void_p,  # z
        ctypes.c_void_p,  # out
        ctypes.c_int,  # B
        ctypes.c_int,  # N
        ctypes.c_int,  # K
        ctypes.c_int,  # order
        ctypes.c_void_p,  # cudaStream_t
    ]
    fn.restype = ctypes.c_int
    return fn


def anova_inter(z: torch.Tensor, order: int) -> torch.Tensor:
    """Σ_{m=2..order} Σ_f ANOVA_m(z[·, ·, f]) per example.  z: [B, N, k] f32 → [B].

    ``anova_inter.launches`` counts kernel launches (never plain-version calls).
    """
    if not MIN_ORDER <= order <= MAX_ORDER:
        raise ValueError(
            f"anova_inter supports orders {MIN_ORDER}..{MAX_ORDER} (the orders "
            f"csrc/anova_fwd.cu instantiates), got {order}"
        )
    if z.device.type == "cpu":
        return anova_inter_plain(z, order)
    if z.device.type != "cuda":
        raise ValueError(f"anova_inter takes cuda or cpu tensors, got {z.device}")
    if z.dim() != 3 or z.dtype != torch.float32 or not z.is_contiguous():
        raise ValueError(
            "anova_inter's kernel takes a contiguous [B, N, k] float32 tensor, "
            f"got shape {tuple(z.shape)} {z.dtype} contiguous={z.is_contiguous()}"
        )
    if max(z.shape) > 2**31 - 1:
        raise ValueError(f"anova_inter: dimension too large for int32: {tuple(z.shape)}")
    kernel = _kernel()
    B, N, K = z.shape
    out = torch.empty((B,), device=z.device, dtype=torch.float32)
    if B == 0 or K == 0:
        return out.zero_()  # nothing to launch: an empty grid is an error
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = kernel(z.data_ptr(), out.data_ptr(), B, N, K, order, stream)
    if rc != 0:
        raise RuntimeError(f"anova_fwd kernel launch failed with CUDA error {rc}")
    anova_inter.launches += 1
    return out


anova_inter.launches = 0
