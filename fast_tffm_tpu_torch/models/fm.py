"""Factorization machine of any order — the counterpart of
``fast_tffm_tpu/models/fm.py``.

Row layout ``[1 + factor_num]``: column 0 is the bias wᵢ, columns 1: the
factors vᵢ.  Scoring runs through ops/fm.py (order 2 through the
``fm2_score`` kernel pair on the card, which also gives the L2 term, and
plain torch on the CPU; order ≥ 3 through the CUDA ANOVA kernels on the
card).
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch, masked_l2
from fast_tffm_tpu_torch.ops.fm import fm2_score_l2, fm_score

__all__ = ["FMModel"]


@dataclasses.dataclass(frozen=True)
class FMModel:
    vocabulary_size: int
    factor_num: int = 8
    order: int = 2
    init_value_range: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0

    uses_fields = False  # score() never reads batch.fields
    dense_names = ()  # no dense parameters

    @property
    def row_dim(self) -> int:
        return 1 + self.factor_num

    def init_table(self, generator: torch.Generator) -> torch.Tensor:
        """[vocabulary_size, row_dim] on the generator's device: factors
        uniform in ±init_value_range, zero bias (the JAX init's
        distribution; the draws themselves differ between frameworks)."""
        r = self.init_value_range
        factors = torch.rand(
            (self.vocabulary_size, self.factor_num),
            generator=generator,
            device=generator.device,
            dtype=torch.float32,
        )
        factors.mul_(2 * r).sub_(r)
        bias = torch.zeros((self.vocabulary_size, 1), device=generator.device)
        return torch.cat([bias, factors], dim=-1)

    def init_dense(self, generator: torch.Generator) -> list[torch.Tensor]:
        """FM has no dense parameters."""
        del generator
        return []

    def score(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense
        return fm_score(rows, batch.vals, order=self.order)

    def regularization(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense
        return masked_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)

    def score_and_regularization(self, rows: torch.Tensor, dense, batch: Batch):
        """(``score``, ``regularization``) in one call: at order 2 the
        ``fm2_score_l2`` pair, which folds the L2 term into the scorer's
        passes on the card; at order ≥ 3 the two methods."""
        if self.order != 2:
            return self.score(rows, dense, batch), self.regularization(rows, dense, batch)
        return fm2_score_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)
