"""The batch every model scores: the device mirror of a ParsedBatch.

The counterpart of ``fast_tffm_tpu/models/base.py::Batch``: a padded
``[B, N]`` batch whose zero-valued slots are padding.  The gather of the
table rows stays outside the model (trainer.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Batch"]


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
