"""FM scoring with its backward passes — the counterpart of ``fast_tffm_tpu/ops/fm.py``.

Batches are padded dense ``[B, N]``; every score term scales with the
feature value xᵢ, so zero-valued padding slots are neutral without masks.
Parameters arrive gathered: ``rows[B, N, 1 + k]`` with column 0 the bias wᵢ
and columns 1: the factors vᵢ.

  order 2:   score = Σᵢ wᵢxᵢ + ½ Σ_f [(Σᵢ vᵢf xᵢ)² − Σᵢ (vᵢf xᵢ)²]
  order t≥3: score = Σᵢ wᵢxᵢ + Σ_{m=2}^{t} Σ_f ANOVA_m(z·f),  z = v·x,
             via the DP  a[j][m] = a[j-1][m] + z_j·a[j-1][m-1]

Order 2 is a ``torch.autograd.Function`` with the hand-derived VJP of
``_fm_score_order2_bwd``, in plain torch, because the JAX package has no
kernel there either.  Order ≥ 3 computes ``linear + anova_inter(z, order)``
as the JAX package's Pallas path does (``ops/fm.py:225-227``): the linear
term and z = v·x are left to autograd, and only the DP carries a
hand-written backward — ``ops/anova.py``, the CUDA kernels on the card.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops.anova import anova_inter

__all__ = ["fm_score"]


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


def fm_score(rows: torch.Tensor, vals: torch.Tensor, order: int = 2) -> torch.Tensor:
    """[B] raw (pre-sigmoid) FM scores of a padded batch, differentiable in
    ``rows`` and ``vals``.

    rows: [B, N, 1 + factor_num] gathered parameter rows; vals: [B, N]
    feature values (0.0 marks padding); order ≥ 2.
    """
    if order < 2:
        raise ValueError(f"FM order must be >= 2, got {order}")
    if order == 2:
        return _FmScoreOrder2.apply(rows, vals)
    linear = torch.sum(rows[..., 0] * vals, dim=-1)
    z = rows[..., 1:] * vals[..., None]  # a fresh contiguous [B, N, k]
    return linear + anova_inter(z, order)
