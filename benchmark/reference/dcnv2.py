"""Plain DCN-V2 (Wang et al., WWW 2021, arXiv:2008.13535), as MLPerf
Training's recommendation benchmark trains it (DLRM-DCNv2): low-rank cross
layers over the embeddings, then a ReLU top MLP to one output.  With x₀ the
value-weighted embeddings of the N slots end to end ([B, N·k], d = N·k):

    x_{l+1} = x₀ ⊙ (U_l (V_lᵀ x_l) + c_l) + x_l,   l = 0 … L−1
    score   = MLP(x_L)   (ReLU between the layers, none after the last)

with V_l = ``wcv{l}`` [d, r], U_l = ``wcu{l}`` [r, d] (stored as the
transposes' [d_in, d_out], so x @ wcv is V_lᵀ x) and c_l = ``bc{l}`` [d];
the MLP's ``w{i}`` [d_in, d_out] and ``b{i}``.  Every matmul, the cross
products included, takes its operands as ``prec.mlp`` rounds them and sums
in float32; the elementwise work and the residual stream are in
``prec.dtype``.

Departures from MLPerf's model, the configuration's and so the program's
as well:

* no bottom MLP: the traffic has no dense features, and its 13 integer
  fields are bucketized categorical fields with embeddings of their own,
  so x₀ is 39·128 = 4,992 wide where MLPerf's is 27·128 = 3,456 (26
  embeddings and the bottom MLP's 128 outputs);
* the table's rows carry a bias column 0 (the layout of every model of the
  port), which DCN-V2 does not have: this score never reads it, so its
  gradient is 0 and, at ``bias_lambda`` 0, so is its update;
* the row accumulator sums g² over the row (``common._adagrad``), where
  FBGEMM's row-wise Adagrad takes its mean.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import round_operand

__all__ = ["width", "dims", "dense_shapes", "cross_layer", "score", "step_flops"]


def width(cfg: dict) -> int:
    """d = N·k."""
    return int(cfg["num_fields"]) * int(cfg["factor_num"])


def dims(cfg: dict) -> tuple:
    """The top MLP's widths, input to output."""
    return (width(cfg), *map(int, cfg["hidden_dims"]), 1)


def dense_shapes(cfg: dict) -> dict:
    d, r = width(cfg), int(cfg["cross_rank"])
    shapes = {}
    for li in range(int(cfg["cross_layers"])):
        shapes[f"wcv{li}"], shapes[f"wcu{li}"], shapes[f"bc{li}"] = (d, r), (r, d), (d,)
    m = dims(cfg)
    for i, (a, b) in enumerate(zip(m[:-1], m[1:])):
        shapes[f"w{i}"], shapes[f"b{i}"] = (a, b), (b,)
    return shapes


def cross_layer(x0, x, v, u, c, prec) -> torch.Tensor:
    """One cross layer: x₀ ⊙ (U (Vᵀ x) + c) + x."""
    dt = prec.dtype
    p = (round_operand(x, prec.mlp) @ round_operand(v, prec.mlp)).to(dt)
    h = (round_operand(p, prec.mlp) @ round_operand(u, prec.mlp)).to(dt)
    return x0 * (h + c.to(dt)) + x


def score(rows, vals, dense, cfg: dict, prec) -> torch.Tensor:
    b, n = vals.shape
    if n != int(cfg["num_fields"]):
        raise ValueError(f"DCN-V2 takes {cfg['num_fields']} slots, got {n}")
    dt = prec.dtype
    r, x = rows.to(dt), vals.to(dt)
    x0 = (r[..., 1:] * x[..., None]).reshape(b, -1)
    h = x0
    for li in range(int(cfg["cross_layers"])):
        h = cross_layer(x0, h, dense[f"wcv{li}"], dense[f"wcu{li}"], dense[f"bc{li}"], prec)
    layers = len(dims(cfg)) - 1
    for i in range(layers):
        prod = round_operand(h, prec.mlp) @ round_operand(dense[f"w{i}"], prec.mlp)
        h = prod.to(dt) + dense[f"b{i}"].to(dt)
        if i < layers - 1:
            h = torch.relu(h)
    return h[:, 0]


def step_flops(cfg: dict, b: int, n: int) -> dict:
    """A training step's operations by precision, counted at their least:
    every product (the cross layers' two and the MLP's), 2·B·in·out forward
    and 4·B·in·out backward, at the operand precision the configuration
    states; in float32 the cross combine (3·B·d forward: an add, a
    multiply, an add; 4·B·d backward: two multiplies, an add for h + c and
    one for the bias sum) a layer, the MLP's bias and ReLU with their
    backward (4·B·out a layer) and the value weighting forward and backward
    (2·B·N·k).  The loss, the sums of a row's gradients and the updates are
    counted with the bytes they move."""
    d, r, k = width(cfg), int(cfg["cross_rank"]), int(cfg["factor_num"])
    layers = int(cfg["cross_layers"])
    m = dims(cfg)
    products = 6.0 * b * (layers * 2 * d * r + sum(a * c for a, c in zip(m[:-1], m[1:])))
    small = 7.0 * b * d * layers + 4.0 * b * sum(m[1:]) + 2.0 * b * n * k
    key = "bf16" if cfg.get("compute_dtype") == "bfloat16" else "fp32"
    out = {"fp32": small}
    out[key] = out.get(key, 0.0) + products
    return out
