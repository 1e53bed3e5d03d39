"""Plain order-2 factorization machine (Rendle, ICDM 2010) from its
definition: the bias terms plus every pair's factor product,

    score = Σᵢ wᵢxᵢ + Σ_{i<j} <vᵢ, vⱼ> xᵢxⱼ,

the pair sum read off the Gram matrix of the value-weighted factors.
Rows are ``[1 + k]``: column 0 the bias wᵢ, columns 1: the factors vᵢ."""

from __future__ import annotations

import torch

__all__ = ["dense_shapes", "fm2", "score", "step_flops"]


def dense_shapes(cfg: dict) -> dict:
    """FM has no dense leaves."""
    return {}


def fm2(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """[B] order-2 scores of rows [B, N, 1 + k] at values [B, N], in the
    rows' dtype."""
    linear = torch.sum(rows[..., 0] * vals, dim=-1)
    vx = rows[..., 1:] * vals[..., None]  # [B, N, k]
    gram = torch.bmm(vx, vx.transpose(1, 2))  # [B, N, N]
    pairs = 0.5 * (gram.sum(dim=(1, 2)) - torch.diagonal(gram, dim1=1, dim2=2).sum(-1))
    return linear + pairs


def score(rows, vals, dense, cfg: dict, prec) -> torch.Tensor:
    if int(cfg.get("order", 2)) != 2:
        raise ValueError("benchmark.reference.fm computes order 2 only")
    return fm2(rows.to(prec.dtype), vals.to(prec.dtype))


def step_flops(cfg: dict, b: int, n: int) -> dict:
    """The floating-point operations one training step needs at batch ``b``
    of ``n`` slots, by precision, counted at their least: the score by its
    O(N·k) form forward (linear 2N, v·x N·k, Σ and Σ² 3N·k, 3k to finish)
    and backward (N for the bias, 3N·k for the factors), and the L2 term
    (2 a row element each way).  The loss, the sums of a row's gradients
    and the update are counted with the bytes they move."""
    k, d = int(cfg["factor_num"]), 1 + int(cfg["factor_num"])
    per_example = (2 * n + 4 * n * k + 3 * k) + (n + 3 * n * k) + 4 * n * d
    return {"fp32": float(b * per_example)}
