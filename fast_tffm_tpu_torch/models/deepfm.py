"""DeepFM: a shared-embedding order-2 FM plus an MLP head (BASELINE config
#4) — the counterpart of ``fast_tffm_tpu/models/deepfm.py``.

The FM half is ``ops/fm.fm_score`` at order 2 over the table rows (in
training ``ops/fm.fm2_score_l2``, which gives the L2 term with it); the deep
half is a ReLU MLP over the example's value-weighted embedding vectors,
``[B, N, k]`` reshaped to ``[B, N·k]``.  Both halves read the same rows, so
one gather and one sparse Adagrad update (kernel B4 on the card) serve
both; the MLP's leaves train by ``optim.dense_adagrad_update``.  The
matmuls are plain torch (cuBLAS on the card), as the JAX package leaves
them to XLA.

The dense leaves are a list in the order ``jax.tree.flatten`` gives the
JAX model's dict: its keys sorted (``b0, b1, …, w0, w1, …``), which is the
order of a checkpoint's ``dense_{i}`` members.  ``_mlp`` looks each leaf up
by name (``dense_names``), never by layer position.

``compute_dtype = bfloat16``: every matmul takes its operands rounded to
bfloat16 and accumulates in float32 (JAX's ``preferred_element_type``), so
the pre-activations stay float32; the master weights stay float32
(``models/base.compute_round``).

Slots are positional: the batch must carry exactly ``num_fields`` slots
(max_nnz = num_fields); any other width is refused with a ValueError.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fast_tffm_tpu_torch.config import check_deepfm_width
from fast_tffm_tpu_torch.models.base import Batch, compute_round, masked_l2
from fast_tffm_tpu_torch.ops.fm import fm2_score_l2, fm_score

__all__ = ["DeepFMModel"]


@dataclasses.dataclass(frozen=True)
class DeepFMModel:
    vocabulary_size: int
    num_fields: int  # fixed feature slots per example (= max_nnz)
    factor_num: int = 8
    hidden_dims: tuple[int, ...] = (400, 400, 400)
    init_value_range: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    compute_dtype: str = "float32"  # float32 | bfloat16 (the MLP matmuls)

    uses_fields = False  # slots are positional (num_fields = max_nnz)

    @property
    def row_dim(self) -> int:
        return 1 + self.factor_num

    @property
    def n_layers(self) -> int:
        return len(self.hidden_dims) + 1

    @property
    def dense_names(self) -> list[str]:
        """The dense leaves' names in ``jax.tree.flatten`` order (sorted keys)."""
        return sorted([f"w{i}" for i in range(self.n_layers)] + [f"b{i}" for i in range(self.n_layers)])

    def init_table(self, generator: torch.Generator) -> torch.Tensor:
        """[vocabulary_size, row_dim]: factors uniform in ±init_value_range,
        zero bias (the JAX init's distribution, not its draws)."""
        r = self.init_value_range
        factors = torch.rand(
            (self.vocabulary_size, self.factor_num),
            generator=generator, device=generator.device, dtype=torch.float32,
        )
        factors.mul_(2 * r).sub_(r)
        bias = torch.zeros((self.vocabulary_size, 1), device=generator.device)
        return torch.cat([bias, factors], dim=-1)

    def init_dense(self, generator: torch.Generator) -> list[torch.Tensor]:
        """He-initialised weights ``w{i}`` [d_in, d_out] and zero biases
        ``b{i}`` [d_out] for the ReLU stack num_fields·k → hidden_dims → 1,
        in ``dense_names`` order."""
        dims = (self.num_fields * self.factor_num, *self.hidden_dims, 1)
        params = {}
        for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            params[f"w{li}"] = torch.randn(
                (d_in, d_out), generator=generator, device=generator.device, dtype=torch.float32
            ) * math.sqrt(2.0 / d_in)
            params[f"b{li}"] = torch.zeros((d_out,), device=generator.device)
        return [params[name] for name in self.dense_names]

    def _mlp(self, dense, x: torch.Tensor) -> torch.Tensor:
        leaf = dict(zip(self.dense_names, dense, strict=True))
        for li in range(self.n_layers):
            x = compute_round(x, self.compute_dtype) @ compute_round(
                leaf[f"w{li}"], self.compute_dtype) + leaf[f"b{li}"]
            if li < self.n_layers - 1:
                x = torch.relu(x)
        return x[..., 0]  # [B]

    def _deep(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        b, n = batch.vals.shape
        emb = rows[..., 1:] * batch.vals[..., None]  # [B, N, k] value-weighted
        return self._mlp(dense, emb.reshape(b, n * self.factor_num))

    def score(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        check_deepfm_width(self.num_fields, batch.vals.shape[1])
        return fm_score(rows, batch.vals, order=2) + self._deep(rows, dense, batch)

    def score_and_regularization(self, rows: torch.Tensor, dense, batch: Batch):
        """(``score``, ``regularization``) in one call: the FM half and the
        L2 term from one ``fm2_score_l2`` (the kernel pair on the card); the
        MLP's gradient into the rows adds onto the pair's under autograd."""
        check_deepfm_width(self.num_fields, batch.vals.shape[1])
        fm_part, reg = fm2_score_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)
        return fm_part + self._deep(rows, dense, batch), reg

    def regularization(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense  # the reference regularizes only the FM parameters
        return masked_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)
