"""Plain DeepFM (Guo et al., IJCAI 2017, arXiv:1703.04247): the order-2 FM
over the shared rows plus a ReLU MLP over the value-weighted embeddings
``[B, N·k]``, through ``hidden_dims`` to one output.

With ``compute_dtype = bfloat16`` each MLP product takes its operands
rounded to bfloat16 and sums in float32 (the configuration's statement);
the master weights stay float32.  Dense leaves: ``w{i}`` [d_in, d_out] and
``b{i}`` [d_out] for layer i."""

from __future__ import annotations

import torch

from benchmark.reference.common import round_operand
from benchmark.reference.fm import fm2
from benchmark.reference.fm import step_flops as fm_flops

__all__ = ["dims", "dense_shapes", "score", "step_flops"]


def dims(cfg: dict) -> tuple:
    return (int(cfg["num_fields"]) * int(cfg["factor_num"]), *map(int, cfg["hidden_dims"]), 1)


def dense_shapes(cfg: dict) -> dict:
    d = dims(cfg)
    shapes = {}
    for i, (a, b) in enumerate(zip(d[:-1], d[1:])):
        shapes[f"w{i}"] = (a, b)
        shapes[f"b{i}"] = (b,)
    return shapes


def score(rows, vals, dense, cfg: dict, prec) -> torch.Tensor:
    b, n = vals.shape
    if n != int(cfg["num_fields"]):
        raise ValueError(f"DeepFM takes {cfg['num_fields']} slots, got {n}")
    dt = prec.dtype
    r, x = rows.to(dt), vals.to(dt)
    h = (r[..., 1:] * x[..., None]).reshape(b, -1)
    layers = len(dims(cfg)) - 1
    for i in range(layers):
        prod = round_operand(h, prec.mlp) @ round_operand(dense[f"w{i}"], prec.mlp)
        h = prod.to(dt) + dense[f"b{i}"].to(dt)
        if i < layers - 1:
            h = torch.relu(h)
    return fm2(r, x) + h[:, 0]


def step_flops(cfg: dict, b: int, n: int) -> dict:
    """The FM half's operations (``fm.step_flops``) and the embedding's
    value weighting forward and backward in float32; the MLP's products,
    2·B·in·out forward and 4·B·in·out backward a layer, at the operand
    precision the configuration states (its bias, ReLU and their
    backward, 4·B·out a layer, in float32)."""
    d = dims(cfg)
    k = int(cfg["factor_num"])
    mlp = 6.0 * b * sum(a * c for a, c in zip(d[:-1], d[1:]))
    small = 2.0 * b * n * k + 4.0 * b * sum(d[1:])
    key = "bf16" if cfg.get("compute_dtype") == "bfloat16" else "fp32"
    out = {"fp32": fm_flops(cfg, b, n)["fp32"] + small}
    out[key] = out.get(key, 0.0) + mlp
    return out
