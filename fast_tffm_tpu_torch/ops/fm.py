"""FM scoring — the counterpart of ``fast_tffm_tpu/ops/fm.py`` (forward only).

Batches are padded dense ``[B, N]``; every score term scales with the
feature value xᵢ, so zero-valued padding slots are neutral without masks.
Parameters arrive gathered: ``rows[B, N, 1 + k]`` with column 0 the bias wᵢ
and columns 1: the factors vᵢ.

  order 2:   score = Σᵢ wᵢxᵢ + ½ Σ_f [(Σᵢ vᵢf xᵢ)² − Σᵢ (vᵢf xᵢ)²]
  order t≥3: score = Σᵢ wᵢxᵢ + Σ_{m=2}^{t} Σ_f ANOVA_m(z·f),  z = v·x,
             via the DP  a[j][m] = a[j-1][m] + z_j·a[j-1][m-1]

Order 2 is plain torch, because the JAX package has no kernel there either.
Order ≥ 3 sends the DP to ``ops/anova.py::anova_inter``, the CUDA kernel on
the card.  The backward passes come with the training slice.
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


def _anova_scan_fwd(z: torch.Tensor, order: int):
    """The DP of ``fast_tffm_tpu/ops/fm.py::_anova_scan_fwd`` as a loop over
    features.  z: [B, N, k] → (a_final [B, order+1, k], a_prevs [N, B,
    order+1, k]); a_prevs holds the carry before each feature (the backward
    pass's residuals).  a[0] ≡ 1."""
    B, N, k = z.shape
    a = z.new_zeros((B, order + 1, k))
    a[:, 0, :] = 1.0
    prevs = []
    for j in range(N):
        prevs.append(a)
        shifted = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)
        a = a + z[:, j, None, :] * shifted
    a_prevs = torch.stack(prevs) if prevs else z.new_zeros((0, B, order + 1, k))
    return a, a_prevs


def fm_score(rows: torch.Tensor, vals: torch.Tensor, order: int = 2) -> torch.Tensor:
    """[B] raw (pre-sigmoid) FM scores of a padded batch.

    rows: [B, N, 1 + factor_num] gathered parameter rows; vals: [B, N]
    feature values (0.0 marks padding); order ≥ 2.
    """
    if order < 2:
        raise ValueError(f"FM order must be >= 2, got {order}")
    if order == 2:
        return _order2_fwd_math(rows, vals)
    linear = torch.sum(rows[..., 0] * vals, dim=-1)
    z = rows[..., 1:] * vals[..., None]  # a fresh contiguous [B, N, k]
    return linear + anova_inter(z, order)
