"""DCN-V2 (Wang et al., WWW 2021, arXiv:2008.13535), as MLPerf Training's
recommendation benchmark trains it (DLRM-DCNv2): low-rank cross layers
over the embeddings, then a ReLU top MLP.  The port's own model: the JAX
package has no DCN-V2, so no cross-package test holds it; the tests hold it
to the plain reference ``benchmark/reference/dcnv2.py``.

With x₀ the example's value-weighted embeddings ``[B, N·k]``
(``models/base.value_weighted``, DeepFM's MLP input) and ``cr`` the
operand rounding of ``compute_dtype`` (``models/base.compute_round``):

    cross layer l:  p = cr(x_l) @ cr(wcv_l),  h = cr(p) @ cr(wcu_l),
                    x_{l+1} = x₀ ⊙ (h + bc_l) + x_l   (``ops/dcn.cross_combine``)
    score:          relu_mlp(x_L) through hidden_dims to one output

with ``wcv_l`` [N·k, r], ``wcu_l`` [r, N·k] and ``bc_l`` [N·k].  The products
are plain torch (cuBLAS on the card); the combine is the kernel pair of
``csrc/dcn_cross.cu`` on the card.  The elementwise work and the residual
stream stay float32.

Row layout ``[1 + k]`` like every model of the port: column 0 is a bias
that DCN-V2 does not have and never reads (its gradient is 0, and with
``bias_lambda`` 0 so is its update).  The dense leaves are a list in sorted
name order (``b0 … bc0 … w0 … wcu0 … wcv0 …``), as DeepFM's, each
``[d_in, d_out]``.  Slots are positional: the batch must carry exactly
``num_fields`` slots (max_nnz = num_fields).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fast_tffm_tpu_torch.config import check_deepfm_width
from fast_tffm_tpu_torch.models.base import (
    Batch,
    compute_round,
    masked_l2,
    relu_mlp,
    value_weighted,
)
from fast_tffm_tpu_torch.models.deepfm import DeepFMModel
from fast_tffm_tpu_torch.ops.dcn import X0Grad, cross_combine
from fast_tffm_tpu_torch.utils.tracing import span

__all__ = ["DCNv2Model"]


@dataclasses.dataclass(frozen=True)
class DCNv2Model:
    vocabulary_size: int
    num_fields: int  # fixed feature slots per example (= max_nnz)
    factor_num: int = 128
    cross_layers: int = 3
    cross_rank: int = 512
    hidden_dims: tuple[int, ...] = (1024, 1024, 512, 256)
    init_value_range: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    compute_dtype: str = "float32"  # float32 | bfloat16 (every matmul's operands)

    uses_fields = False  # slots are positional (num_fields = max_nnz)

    @property
    def row_dim(self) -> int:
        return 1 + self.factor_num

    @property
    def width(self) -> int:
        """d = N·k, the cross network's width."""
        return self.num_fields * self.factor_num

    @property
    def n_layers(self) -> int:
        """The top MLP's layers."""
        return len(self.hidden_dims) + 1

    def dense_shapes(self) -> dict[str, tuple[int, ...]]:
        d, r = self.width, self.cross_rank
        shapes = {}
        for li in range(self.cross_layers):
            shapes[f"wcv{li}"], shapes[f"wcu{li}"], shapes[f"bc{li}"] = (d, r), (r, d), (d,)
        dims = (d, *self.hidden_dims, 1)
        for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"w{li}"], shapes[f"b{li}"] = (d_in, d_out), (d_out,)
        return shapes

    @property
    def dense_names(self) -> list[str]:
        """The dense leaves' names, sorted (the checkpoint's ``dense_{i}`` order)."""
        return sorted(self.dense_shapes())

    # DeepFM's: factors uniform in ±init_value_range, a zero bias column.
    init_table = DeepFMModel.init_table

    def init_dense(self, generator: torch.Generator) -> list[torch.Tensor]:
        """He-initialised weights (``w*``, fan-in their first dimension) and
        zero biases, in ``dense_names`` order."""
        shapes = self.dense_shapes()
        params = {}
        for name, shape in shapes.items():  # drawn in layer order
            if name.startswith("w"):
                params[name] = torch.randn(
                    shape, generator=generator, device=generator.device, dtype=torch.float32
                ) * math.sqrt(2.0 / shape[0])
            else:
                params[name] = torch.zeros(shape, device=generator.device)
        return [params[name] for name in self.dense_names]

    def score(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        check_deepfm_width(self.num_fields, batch.vals.shape[1], "dcnv2")
        leaf = dict(zip(self.dense_names, dense, strict=True))
        cr = self.compute_dtype
        with span("cross"):
            x0 = value_weighted(rows, batch.vals)
            acc = X0Grad(self.cross_layers)
            x = x0
            for li in range(self.cross_layers):
                p = compute_round(x, cr) @ compute_round(leaf[f"wcv{li}"], cr)
                h = compute_round(p, cr) @ compute_round(leaf[f"wcu{li}"], cr)
                x = cross_combine(x0, h, leaf[f"bc{li}"], x, acc)
        with span("mlp"):
            return relu_mlp(leaf, x, self.n_layers, cr)

    def regularization(self, rows: torch.Tensor, dense, batch: Batch) -> torch.Tensor:
        del dense  # as DeepFM: the L2 term covers the table's rows only
        return masked_l2(rows, batch.vals, self.bias_lambda, self.factor_lambda)
