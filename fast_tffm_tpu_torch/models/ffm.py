"""Field-aware factorization machine (BASELINE config #3) — the counterpart
of ``fast_tffm_tpu/models/ffm.py``.

Each feature i keeps one factor vector per field: score =

    Σᵢ wᵢxᵢ + Σ_{i<j} ⟨v_{i, field_j}, v_{j, field_i}⟩ xᵢxⱼ

Row layout ``[1 + num_fields·k]``: column 0 the bias, then the per-field
factor blocks.  The pairwise sum is re-associated as in the JAX package,
into a field-pair tensor ``T[a, b] = Σ_{i: fᵢ = a} xᵢ·vᵢ[b]``:

    ½ (Σ_{a,b} ⟨T[a,b], T[b,a]⟩ − Σᵢ ⟨xᵢvᵢ[fᵢ], xᵢvᵢ[fᵢ]⟩)

two einsums and elementwise math instead of an O(N²) loop; x folds into
the one-hot operand ``w[b, n, a] = x·1[f = a]``.  Padding (x = 0) is
neutral, and a field id outside [0, F) one-hots to zeros, as
``jax.nn.one_hot`` gives them.  The einsums are plain torch (cuBLAS
batched products on the card), as the JAX package leaves them to XLA.

``compute_dtype = bfloat16`` rounds the einsums' operands to bfloat16 and
accumulates their products in float32 (JAX's ``preferred_element_type``),
see ``models/base.compute_round``.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.models.base import Batch, compute_round, masked_l2

__all__ = ["FFMModel", "one_hot"]


def one_hot(fields: torch.Tensor, num: int, dtype=torch.float32) -> torch.Tensor:
    """[..., num] one-hot of integer ``fields``; an id outside [0, num) gives
    a zero row (``jax.nn.one_hot``'s rule; ``torch.nn.functional.one_hot``
    raises on it and takes int64 only)."""
    classes = torch.arange(num, dtype=fields.dtype, device=fields.device)
    return (fields[..., None] == classes).to(dtype)


@dataclasses.dataclass(frozen=True)
class FFMModel:
    vocabulary_size: int
    num_fields: int
    factor_num: int = 4
    init_value_range: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    compute_dtype: str = "float32"  # interaction einsum operands (float32 | bfloat16)

    uses_fields = True  # score() one-hots batch.fields per slot
    dense_names = ()  # no dense parameters

    @property
    def row_dim(self) -> int:
        return 1 + self.num_fields * self.factor_num

    def init_table(self, generator: torch.Generator) -> torch.Tensor:
        """[vocabulary_size, row_dim]: factors uniform in ±init_value_range,
        zero bias (the JAX init's distribution, not its draws)."""
        r = self.init_value_range
        factors = torch.rand(
            (self.vocabulary_size, self.num_fields * self.factor_num),
            generator=generator, device=generator.device, dtype=torch.float32,
        )
        factors.mul_(2 * r).sub_(r)
        bias = torch.zeros((self.vocabulary_size, 1), device=generator.device)
        return torch.cat([bias, factors], dim=-1)

    def init_dense(self, generator: torch.Generator) -> list[torch.Tensor]:
        """FFM has no dense parameters."""
        del generator
        return []

    def score(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense
        b, n = batch.vals.shape
        f, k = self.num_fields, self.factor_num
        linear = torch.sum(rows[..., 0] * batch.vals, dim=-1)
        v = compute_round(rows[..., 1:].reshape(b, n, f, k), self.compute_dtype)
        woh = one_hot(batch.fields, f) * compute_round(batch.vals, self.compute_dtype)[..., None]
        # T[b, a, g, :] = Σ_{i: field_i = a} x_i · v[b, i, g, :]
        t = torch.einsum("bna,bngk->bagk", woh, v)
        cross = torch.einsum("bagk,bgak->b", t, t)
        # The diagonal (i == j): x_i · v_i[f_i] per slot.
        z_self = torch.einsum("bnfk,bnf->bnk", v, woh)
        diag = torch.sum(z_self * z_self, dim=(1, 2))
        return linear + 0.5 * (cross - diag)

    def regularization(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense
        return masked_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)
