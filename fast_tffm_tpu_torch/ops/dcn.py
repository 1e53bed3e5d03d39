"""The DCN-V2 cross layer's combine with its backward (``models/dcnv2.py``).

A cross layer of DCN-V2 (Wang et al., WWW 2021, arXiv:2008.13535) is

    x_{l+1} = x₀ ⊙ (U_l (V_lᵀ x_l) + c_l) + x_l,

whose low-rank product ``h = U_l (V_lᵀ x_l)`` the model leaves to
``torch.matmul`` (cuBLAS on the card).  ``cross_combine`` is the rest,
``y = x₀ ⊙ (h + c) + x_l`` over [B, d] rows, one ``torch.autograd.Function``
whose backward gives

    ∂L/∂h = g ⊙ x₀,  ∂L/∂x₀ = g ⊙ (h + c),  ∂L/∂c = Σ_B g ⊙ x₀,  ∂L/∂x_l = g

(``g`` itself, no copy).  Every layer of a network reads the same x₀, so its
gradient is a sum over the layers: the layers of one forward share an
``X0Grad``, into which each layer's backward adds its part in place (the
first to run writes it), and the last to run hands the sum to autograd.

On a CUDA tensor the pair runs as the kernels of ``csrc/dcn_cross.cu``
(``dcn_cross_fwd_kernel``, ``dcn_cross_bwd_kernel``: one pass each, the
bias sum as fixed per-chunk partials and one ``torch.sum``, no atomics);
on a CPU tensor as its plain twin (``cross_fwd_plain``,
``cross_bwd_plain``), which rounds every product and sum as the kernels
do.  A CUDA tensor never falls back to the twin.  ``dcn_cross_fwd.launches``
and ``dcn_cross_bwd.launches`` count the kernels' launches (not those a
CUDA-graph capture records).  The backward runs inside the span ``cross``.
"""

from __future__ import annotations

import ctypes

import torch

from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.utils.tracing import span

__all__ = ["X0Grad", "cross_combine", "cross_fwd_plain", "cross_bwd_plain", "dcn_cross_fwd",
           "dcn_cross_bwd"]


class X0Grad:
    """∂L/∂x₀ of one forward of a cross network of ``layers`` layers: each
    layer's backward adds its part into ``grad`` (the first writes it), and
    the last of the ``layers`` to run returns it to autograd and resets, so a
    second backward over a retained graph sums afresh."""

    def __init__(self, layers: int):
        self.layers = layers
        self.pending = layers
        self.grad = None

    def take(self) -> torch.Tensor | None:
        """After one layer's part: the sum when every layer has added its
        own (then reset), else None."""
        self.pending -= 1
        if self.pending:
            return None
        grad, self.grad, self.pending = self.grad, None, self.layers
        return grad


def cross_fwd_plain(x0, h, c, xl):
    """y = x₀ ⊙ (h + c) + x_l, each operation rounded on its own."""
    return x0 * (h + c) + xl


def cross_bwd_plain(g, x0, h, c, d_x0, mode: int):
    """(∂L/∂h, ∂L/∂c) from ``g``, and ∂L/∂x₀'s part g ⊙ (h + c) into
    ``d_x0`` per ``mode``: 0 none, 1 written (``d_x0`` None: returned new),
    2 added into ``d_x0`` in place.  Returns (d_h, d_c, d_x0)."""
    d_h = g * x0
    if mode:
        part = g * (h + c)
        d_x0 = part if mode == 1 else d_x0.add_(part)
    return d_h, d_h.sum(0), d_x0


def _lib_fn(name: str, argtypes):
    fn = getattr(kernel_build.load("dcn_cross"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, kernel, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        rc = kernel(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def dcn_cross_fwd(x0, h, c, xl) -> torch.Tensor:
    """The forward kernel on contiguous float32 CUDA tensors: y [B, d]."""
    kernel = _lib_fn("dcn_cross_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p])
    b, d = x0.shape
    y = torch.empty_like(x0)
    if b == 0:
        return y  # nothing to launch: an empty grid is an error
    _launch("dcn_cross_fwd", kernel, x0, h, c, xl, y, b, d)
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        dcn_cross_fwd.launches += 1
    return y


def dcn_cross_bwd(g, x0, h, c, d_x0, mode: int):
    """The backward kernel: (d_h [B, d], d_c [d], d_x0) as
    ``cross_bwd_plain`` gives them; the bias sum is the kernel's per-chunk
    partials summed by one ``torch.sum``."""
    kernel = _lib_fn("dcn_cross_bwd", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    b, d = x0.shape
    d_h = torch.empty_like(x0)
    if mode == 1:
        d_x0 = torch.empty_like(x0)
    if b == 0:
        return d_h, torch.zeros_like(c), d_x0
    rows = kernel_build.load("dcn_cross").dcn_cross_chunk_rows()
    partial = torch.empty(((b + rows - 1) // rows, d), device=x0.device, dtype=torch.float32)
    _launch("dcn_cross_bwd", kernel, g, x0, h, c, d_h, d_x0 if mode else 0, partial, b, d, mode)
    if not torch.cuda.is_current_stream_capturing():
        dcn_cross_bwd.launches += 1
    return d_h, torch.sum(partial, 0), d_x0


dcn_cross_fwd.launches = 0
dcn_cross_bwd.launches = 0


def _check_cuda(x0, h, c, xl) -> None:
    if x0.dim() != 2 or h.shape != x0.shape or xl.shape != x0.shape or c.shape != x0.shape[1:]:
        raise ValueError(f"the dcn_cross kernels take x0, h, xl [B, d] and c [d], got "
                         f"{tuple(x0.shape)}, {tuple(h.shape)}, {tuple(c.shape)}, "
                         f"{tuple(xl.shape)}")
    for t in (x0, h, c, xl):
        if t.device != x0.device or t.dtype != torch.float32:
            raise ValueError(f"the dcn_cross kernels take float32 tensors on one card, got "
                             f"{t.dtype} on {t.device}")
    b, d = x0.shape
    if b > 65535 * 32 or d > 2**31 - 1:
        raise ValueError(f"dcn_cross: shape too large for one launch: {tuple(x0.shape)}")


class _CrossCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, h, c, xl, acc):
        ctx.save_for_backward(x0, h, c)
        ctx.acc = acc
        if x0.device.type == "cpu":
            return cross_fwd_plain(x0, h, c, xl)
        return dcn_cross_fwd(x0, h, c, xl)

    @staticmethod
    def backward(ctx, g):
        x0, h, c = ctx.saved_tensors
        acc = ctx.acc
        g = g.contiguous()
        mode = 0
        if ctx.needs_input_grad[0]:
            mode = 1 if acc is None or acc.grad is None else 2
        with span("cross"):
            bwd = cross_bwd_plain if x0.device.type == "cpu" else dcn_cross_bwd
            d_h, d_c, d_x0 = bwd(g, x0, h, c, None if acc is None else acc.grad, mode)
        if mode and acc is not None:
            acc.grad = d_x0
            d_x0 = acc.take()
        return d_x0, d_h, d_c, g, None


def cross_combine(x0: torch.Tensor, h: torch.Tensor, c: torch.Tensor, xl: torch.Tensor,
                  acc: X0Grad | None = None) -> torch.Tensor:
    """y = x₀ ⊙ (h + c) + x_l over [B, d] rows and the bias c [d],
    differentiable in all four.  The layers of one network pass one ``acc``
    (``X0Grad(layers)``): x₀'s gradient is then summed in place across them
    and handed to autograd once; without it each call returns its own part.

    On a CPU tensor it is the plain twin; on a CUDA tensor the kernel pair
    of ``csrc/dcn_cross.cu`` (float32 only)."""
    if x0.device.type == "cuda":
        _check_cuda(x0, h, c, xl)
        kernel_build.load("dcn_cross")  # a missing nvcc raises before any autograd state
        x0, h, c, xl = (t.contiguous() for t in (x0, h, c, xl))
    elif x0.device.type != "cpu":
        raise ValueError(f"cross_combine takes cuda or cpu tensors, got {x0.device}")
    return _CrossCombine.apply(x0, h, c, xl, acc)
