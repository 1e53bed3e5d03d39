"""The batch every model scores, and the losses every model trains on.

The counterpart of ``fast_tffm_tpu/models/base.py``: ``Batch`` is a padded
``[B, N]`` batch whose zero-valued slots are padding, ``masked_l2`` the
reference-style L2 over the gathered rows (defined beside the order-2
scorer in ``ops/fm.py``, whose kernel pair folds it in) and
``logistic_loss`` the weighted mean sigmoid cross-entropy.  The gather of the table rows stays
outside the model (trainer.py), as in the JAX package.  The deep models
(DeepFM, DCN-V2) share ``value_weighted``, their dense input, and
``relu_mlp``, their MLP over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fast_tffm_tpu_torch.ops.fm import masked_l2

__all__ = ["Batch", "masked_l2", "logistic_per_example", "logistic_loss", "compute_round",
           "value_weighted", "relu_mlp"]


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
    def from_parsed(parsed, weights=None, device="cpu", *, with_fields: bool = False):
        """Host ParsedBatch → Batch on ``device`` (the per-step H2D copy).

        ``with_fields=True`` ships the [B, N] field matrix, else a [B, 0]
        placeholder: only FFM reads ``fields`` (``uses_fields``), and for
        the other models it is a third of the bytes copied.  Callers pass
        the model's ``uses_fields``."""
        w = np.ones_like(parsed.labels) if weights is None else np.asarray(weights, np.float32)
        fields = parsed.fields if with_fields else np.zeros((parsed.labels.shape[0], 0), np.int32)
        host = Batch(
            labels=torch.from_numpy(np.ascontiguousarray(parsed.labels)),
            ids=torch.from_numpy(parsed.ids.astype(np.int32, copy=False)),
            vals=torch.from_numpy(np.ascontiguousarray(parsed.vals)),
            fields=torch.from_numpy(np.ascontiguousarray(fields, np.int32)),
            weights=torch.from_numpy(np.ascontiguousarray(w)),
        )
        return host if torch.device(device).type == "cpu" else host.to(device)

    @staticmethod
    def stack_parsed(parsed_seq, weights_seq=None, *, with_fields: bool = False):
        """K host ParsedBatches → ONE host superbatch [K, B, ...]
        (``steps_per_call`` > 1), so each field crosses to the card once
        per K steps.  ``fields`` follows ``from_parsed``'s rule ([K, B, 0]
        when unused); ids become int32 whatever the parser gave (the native
        stream's int32, the Python parser's int64), so both give the same
        tensors."""
        if weights_seq is None:
            weights_seq = [None] * len(parsed_seq)
        k, b = len(parsed_seq), parsed_seq[0].labels.shape[0]
        return Batch(
            labels=torch.from_numpy(np.stack([p.labels for p in parsed_seq])),
            ids=torch.from_numpy(np.stack([p.ids.astype(np.int32, copy=False) for p in parsed_seq])),
            vals=torch.from_numpy(np.stack([p.vals for p in parsed_seq])),
            fields=torch.from_numpy(
                np.stack([p.fields.astype(np.int32, copy=False) for p in parsed_seq])
                if with_fields
                else np.zeros((k, b, 0), np.int32)
            ),
            weights=torch.from_numpy(np.stack([
                np.ones_like(p.labels) if w is None else np.asarray(w, np.float32)
                for p, w in zip(parsed_seq, weights_seq)
            ])),
        )


def compute_round(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """A matmul operand in ``compute_dtype``, held as float32: ``bfloat16``
    rounds it to bfloat16 and back, so a float32 product of such operands
    is exact per term and sums in float32, which is what the JAX package's
    bf16 ``dot`` with ``preferred_element_type=float32`` computes (a
    bf16-output product would round the pre-activations).  Its backward
    rounds the operand's gradient to bfloat16 at the same point as the
    transpose of JAX's ``astype``.  ``float32`` returns ``x``."""
    if compute_dtype == "float32":
        return x
    return x.to(torch.bfloat16).to(torch.float32)


def value_weighted(rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """[B, N·k]: each slot's factors (``rows[..., 1:]``) times its value,
    the slots end to end.  Slots are positional, so N is the model's
    ``num_fields``."""
    b, n = vals.shape
    return (rows[..., 1:] * vals[..., None]).reshape(b, -1)


def relu_mlp(leaf: dict, x: torch.Tensor, n_layers: int, compute_dtype: str) -> torch.Tensor:
    """[B]: the ReLU stack ``x @ w{i} + b{i}`` over ``leaf``'s ``w{i}``
    [d_in, d_out] and ``b{i}`` [d_out], i < ``n_layers``, no ReLU after the
    last layer, whose one output is the result.  Each product takes its
    operands through ``compute_round``."""
    for li in range(n_layers):
        x = compute_round(x, compute_dtype) @ compute_round(leaf[f"w{li}"], compute_dtype) + leaf[f"b{li}"]
        if li < n_layers - 1:
            x = torch.relu(x)
    return x[..., 0]


def logistic_per_example(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example sigmoid cross-entropy, log(1 + e^{-yx}) in the stable
    log-sum-exp form, whose gradient is sigmoid(s) - y at every score.

    The form's max(s, 0) and |s| have no derivative at s = 0, where autograd
    takes 1 and 0 and the form's gradient would be 1 - y instead of 1/2 - y:
    a score that is exactly 0 on one device and a few ulps off it on another
    would then take gradients a factor of 2 apart.  The last term is 0 in
    value, -1/2 in gradient at s = 0 exactly and an exact 0 elsewhere, so
    every loss and every other gradient is the form's own, bit for bit."""
    per = torch.clamp_min(scores, 0.0) - scores * labels + torch.log1p(torch.exp(-torch.abs(scores)))
    return per - 0.5 * torch.where(scores == 0, scores, torch.zeros_like(scores))


def logistic_loss(scores: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor):
    """Weighted mean sigmoid cross-entropy (the reference's training loss)."""
    per = logistic_per_example(scores, labels)
    denom = torch.clamp_min(torch.sum(weights), 1.0)
    return torch.sum(per * weights) / denom
