"""The batch every model scores, and the losses every model trains on.

The counterpart of ``fast_tffm_tpu/models/base.py``: ``Batch`` is a padded
``[B, N]`` batch whose zero-valued slots are padding, ``masked_l2`` the
reference-style L2 over the gathered rows and ``logistic_loss`` the
weighted mean sigmoid cross-entropy.  The gather of the table rows stays
outside the model (trainer.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Batch", "masked_l2", "logistic_loss"]


@dataclasses.dataclass(frozen=True)
class Batch:
    labels: torch.Tensor  # [B] f32
    ids: torch.Tensor  # [B, N] i32
    vals: torch.Tensor  # [B, N] f32 (0 = padding)
    fields: torch.Tensor  # [B, N] i32, or [B, 0] when the model ignores fields
    weights: torch.Tensor  # [B] f32 example weights (0 = padded row)

    def to(self, device, non_blocking: bool = False) -> "Batch":
        return Batch(
            **{
                f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
                for f in dataclasses.fields(self)
            }
        )

    @staticmethod
    def from_parsed(parsed, weights=None, device="cpu"):
        """Host ParsedBatch → Batch on ``device`` (the per-step H2D copy).

        ``fields`` is a [B, 0] placeholder instead of the [B, N] field
        matrix: only FFM reads it, a later slice."""
        w = np.ones_like(parsed.labels) if weights is None else np.asarray(weights, np.float32)
        fields = np.zeros((parsed.labels.shape[0], 0), np.int32)
        host = Batch(
            labels=torch.from_numpy(np.ascontiguousarray(parsed.labels)),
            ids=torch.from_numpy(parsed.ids.astype(np.int32, copy=False)),
            vals=torch.from_numpy(np.ascontiguousarray(parsed.vals)),
            fields=torch.from_numpy(np.ascontiguousarray(fields)),
            weights=torch.from_numpy(np.ascontiguousarray(w)),
        )
        return host if torch.device(device).type == "cpu" else host.to(device)


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


def logistic_loss(scores: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
    """Weighted mean sigmoid cross-entropy (the reference's training loss)."""
    # log(1 + e^{-yx}) in the stable log-sum-exp form.
    per = torch.clamp_min(scores, 0.0) - scores * labels + torch.log1p(torch.exp(-torch.abs(scores)))
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    return torch.sum(per * weights) / denom
