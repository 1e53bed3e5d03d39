"""FM scoring with its backward passes — the counterpart of ``fast_tffm_tpu/ops/fm.py``.

Batches are padded dense ``[B, N]``; every score term scales with the
feature value xᵢ, so zero-valued padding slots are neutral without masks.
Parameters arrive gathered: ``rows[B, N, 1 + k]`` with column 0 the bias wᵢ
and columns 1: the factors vᵢ.

  order 2:   score = Σᵢ wᵢxᵢ + ½ Σ_f [(Σᵢ vᵢf xᵢ)² − Σᵢ (vᵢf xᵢ)²]
  order t≥3: score = Σᵢ wᵢxᵢ + Σ_{m=2}^{t} Σ_f ANOVA_m(z·f),  z = v·x,
             via the DP  a[j][m] = a[j-1][m] + z_j·a[j-1][m-1]

Order 2 on a CPU tensor is a ``torch.autograd.Function`` with the
hand-derived VJP of ``_fm_score_order2_bwd``, in plain torch, because the
JAX package has no kernel there either.  On a CUDA tensor it is the kernel
pair of ``csrc/fm2_score.cu`` (``fm2_score_l2``): one pass over the rows
forward and one backward, with the masked L2 term of ``masked_l2`` folded
in, where the plain composition under autograd makes ~30.  Order ≥ 3
computes ``linear + anova_inter(z, order)`` as the JAX package's Pallas
path does (``ops/fm.py:225-227``): the linear term and z = v·x are left to
autograd, and only the DP carries a hand-written backward —
``ops/anova.py``, the CUDA kernels on the card.

A wrapper takes the plain version only for a CPU tensor.  For a CUDA tensor
it launches the kernel or raises, never falling back.
``fm2_score_fwd.launches`` and ``fm2_score_bwd.launches`` count the pair's
launches (not those a CUDA-graph capture records).
"""

from __future__ import annotations

import ctypes

import torch

from fast_tffm_tpu_torch.ops import kernel_build
from fast_tffm_tpu_torch.ops.anova import anova_inter

__all__ = ["fm_score", "fm2_score_l2", "fm2_score_fwd", "fm2_score_bwd", "masked_l2"]


def masked_l2(rows: torch.Tensor, vals: torch.Tensor, bias_lambda: float, factor_lambda: float):
    """Reference-style L2 over the batch's gathered rows, col 0 = bias.

    Padding slots (vals == 0) gather row 0 arbitrarily and must not be
    penalized, hence the mask.  Duplicate occurrences are each penalized,
    matching a per-batch ‖params‖² over the gathered (not deduped) rows.
    """
    mask = (vals != 0.0).to(rows.dtype)[..., None]
    masked = rows * mask
    bias_term = torch.sum(masked[..., 0] ** 2)
    factor_term = torch.sum(masked[..., 1:] ** 2)
    return bias_lambda * bias_term + factor_lambda * factor_term


def _order2_fwd_math(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """rows: [B, N, 1+k], vals: [B, N] → scores [B]."""
    linear = torch.sum(rows[..., 0] * vals, dim=-1)
    vx = rows[..., 1:] * vals[..., None]
    s1 = torch.sum(vx, dim=1)
    s2 = torch.sum(vx * vx, dim=1)
    return linear + 0.5 * torch.sum(s1 * s1 - s2, dim=-1)


class _FmScoreOrder2(torch.autograd.Function):
    """Order-2 score with the hand-derived backward (the reference's FmGrad):

    ∂score/∂wᵢ = xᵢ,  ∂score/∂vᵢ = xᵢ·(s1 − vᵢxᵢ),  ∂score/∂xᵢ = wᵢ + vᵢ·(s1 − vᵢxᵢ)
    """

    @staticmethod
    def forward(ctx, rows, vals):
        ctx.save_for_backward(rows, vals)
        return _order2_fwd_math(rows, vals)

    @staticmethod
    def backward(ctx, g):
        rows, vals = ctx.saved_tensors
        bias, v = rows[..., 0], rows[..., 1:]
        vx = v * vals[..., None]
        s1 = torch.sum(vx, dim=1)
        g_ = g[:, None]  # [B, 1]
        d_bias = g_ * vals  # [B, N]
        resid = s1[:, None, :] - vx  # [B, N, k]
        d_v = g_[..., None] * vals[..., None] * resid
        d_rows = torch.cat([d_bias[..., None], d_v], dim=-1)
        d_vals = g_ * (bias + torch.sum(v * resid, dim=-1))
        return d_rows, d_vals


def _lib_fn(name: str, argtypes):
    fn = getattr(kernel_build.load("fm2_score"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(rows: torch.Tensor, vals: torch.Tensor) -> None:
    if rows.dim() != 3 or rows.shape[-1] < 1 or vals.shape != rows.shape[:2]:
        raise ValueError(f"the fm2_score kernels take rows [B, N, D >= 1] and vals [B, N], got "
                         f"{tuple(rows.shape)} and {tuple(vals.shape)}")
    for t in (rows, vals):
        if t.device != rows.device or t.dtype != torch.float32:
            raise ValueError(f"the fm2_score kernels take float32 tensors on one card, got "
                             f"{t.dtype} on {t.device}")
    b, n, d = rows.shape
    if max(b, n * d) > 2**31 - 1:
        raise ValueError(f"fm2_score: dimension too large for int32: {tuple(rows.shape)}")


def fm2_score_fwd(rows, vals, lambdas, want_s1: bool):
    """The forward kernel on contiguous float32 CUDA tensors: (scores [B],
    s1 [B, k] or None, the per-example λ-weighted L2 partials [B] or None
    when ``lambdas`` is None)."""
    kernel = _lib_fn("fm2_score_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    b, n, d = rows.shape
    scores = torch.empty((b,), device=rows.device, dtype=torch.float32)
    s1 = torch.empty((b, d - 1), device=rows.device, dtype=torch.float32) if want_s1 else None
    partial = None if lambdas is None else torch.empty_like(scores)
    if b == 0:
        return scores, s1, partial  # nothing to launch: an empty grid is an error
    lam_b, lam_f = lambdas or (0.0, 0.0)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = kernel(rows.data_ptr(), vals.data_ptr(), scores.data_ptr(),
                    None if s1 is None else s1.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    b, n, d, lam_b, lam_f, stream)
    if rc != 0:
        raise RuntimeError(f"fm2_score_fwd kernel launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():  # a capture launches nothing
        fm2_score_fwd.launches += 1
    return scores, s1, partial


def fm2_score_bwd(rows, vals, s1, g_score, g_reg, lambdas):
    """The backward kernel: d_rows [B, N, D] from the score cotangents
    ``g_score`` [B] and, when ``lambdas`` is not None, the L2 term's
    cotangent ``g_reg`` (a 0-d tensor, read on the card)."""
    kernel = _lib_fn("fm2_score_bwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                     + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    b, n, d = rows.shape
    d_rows = torch.empty_like(rows)
    if b == 0:
        return d_rows
    lam_b, lam_f = lambdas or (0.0, 0.0)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = kernel(rows.data_ptr(), vals.data_ptr(), s1.data_ptr(), g_score.data_ptr(),
                    None if lambdas is None else g_reg.data_ptr(), d_rows.data_ptr(),
                    b, n, d, lam_b, lam_f, stream)
    if rc != 0:
        raise RuntimeError(f"fm2_score_bwd kernel launch failed with CUDA error {rc}")
    if not torch.cuda.is_current_stream_capturing():
        fm2_score_bwd.launches += 1
    return d_rows


fm2_score_fwd.launches = 0
fm2_score_bwd.launches = 0


class _Fm2Kernel(torch.autograd.Function):
    """The kernel pair: scores, and with ``lambdas`` = (λ_b, λ_f) also the
    masked L2 term (the sum of the forward's per-example partials); its
    backward is one kernel that writes d_rows, the L2 term's gradient
    folded in.  No gradient for ``vals``."""

    @staticmethod
    def forward(ctx, rows, vals, lambdas):
        if ctx.needs_input_grad[1]:
            raise ValueError("the fm2_score kernels compute no gradient for vals: a CUDA "
                             "tensor of feature values must not require one")
        scores, s1, partial = fm2_score_fwd(rows, vals, lambdas, ctx.needs_input_grad[0])
        ctx.save_for_backward(rows, vals, s1)
        ctx.lambdas = lambdas
        if lambdas is None:
            return scores
        return scores, torch.sum(partial)

    @staticmethod
    def backward(ctx, g_score, g_reg=None):
        rows, vals, s1 = ctx.saved_tensors
        d_rows = fm2_score_bwd(rows, vals, s1, g_score.contiguous(), g_reg, ctx.lambdas)
        return d_rows, None, None


def _fm2_cuda(rows, vals, lambdas):
    _check_cuda(rows, vals)
    kernel_build.load("fm2_score")  # a missing nvcc raises before any autograd state
    return _Fm2Kernel.apply(rows.contiguous(), vals.contiguous(), lambdas)


def fm2_score_l2(rows: torch.Tensor, vals: torch.Tensor, bias_lambda: float,
                 factor_lambda: float):
    """(scores [B], L2 term) of an order-2 FM batch: ``fm_score(rows, vals,
    2)`` and ``masked_l2(rows, vals, bias_lambda, factor_lambda)`` in one
    call, differentiable in ``rows``.

    On a CPU tensor it is exactly those two, through autograd (and
    differentiable in ``vals`` too).  On a CUDA tensor it is the kernel pair
    of ``csrc/fm2_score.cu``, which raises if ``vals`` requires a gradient."""
    if rows.device.type == "cpu":
        return (_FmScoreOrder2.apply(rows, vals),
                masked_l2(rows, vals, bias_lambda, factor_lambda))
    if rows.device.type != "cuda":
        raise ValueError(f"fm2_score_l2 takes cuda or cpu tensors, got {rows.device}")
    return _fm2_cuda(rows, vals, (float(bias_lambda), float(factor_lambda)))


def fm_score(rows: torch.Tensor, vals: torch.Tensor, order: int = 2) -> torch.Tensor:
    """[B] raw (pre-sigmoid) FM scores of a padded batch, differentiable in
    ``rows`` (and in ``vals`` on the CPU; order ≥ 3 on the card too).

    rows: [B, N, 1 + factor_num] gathered parameter rows; vals: [B, N]
    feature values (0.0 marks padding); order ≥ 2.  Order 2 on a CUDA
    tensor is the forward kernel of ``fm2_score_l2`` without the L2 term
    (with its backward kernel under autograd).
    """
    if order < 2:
        raise ValueError(f"FM order must be >= 2, got {order}")
    if order == 2:
        if rows.device.type == "cuda":
            return _fm2_cuda(rows, vals, None)
        return _FmScoreOrder2.apply(rows, vals)
    linear = torch.sum(rows[..., 0] * vals, dim=-1)
    z = rows[..., 1:] * vals[..., None]  # a fresh contiguous [B, N, k]
    return linear + anova_inter(z, order)
