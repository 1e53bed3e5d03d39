"""What the plain references share: the benchmark's draw of the starting
weights, the precisions, the loss, the L2 term, Adagrad, and the loop
that follows the first training steps.

The starting table is drawn by the benchmark, not by the program: chunk
``c`` of ``TABLE_CHUNK_ROWS`` rows takes ``uniform(-r, r)`` from a
generator of its own, and column 0 (the bias) is zero, the port's init
distribution.  The harness hands the drawn table to the port; the
reference draws again, chunk by chunk, the rows it needs.  The
accumulators start at the configuration's ``init_accumulator_value``.

The loop computes in the configuration's precision (float32; an MLP
whose ``compute_dtype`` is bfloat16 takes operands rounded to bfloat16 and
sums in float32, TF32 off) or, as the control, one step below it
(``lower_precision``).  Gradients of one row's occurrences are summed in
float64.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from benchmark.traffic import sub_seed

__all__ = ["TABLE_CHUNK_ROWS", "Precision", "model_module", "row_dim",
           "accum_width", "draw_table", "initial_rows", "draw_dense", "config_precision",
           "lower_precision", "lower_mlp_precision", "round_operand", "logistic_loss", "masked_l2",
           "reference_steps"]

TABLE_CHUNK_ROWS = 1 << 24
FP8_MAX = 448.0  # largest finite float8_e4m3fn


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype  # the scorer's, the loss's and the backward's arithmetic
    mlp: str  # MLP operands: "none" (as dtype), "bf16" or "fp8" rounding, float32 sums


def model_module(cfg: dict):
    """``benchmark.reference.<model>``: ``dense_shapes``, ``score``,
    ``step_flops``."""
    return importlib.import_module(f"benchmark.reference.{cfg['model']}")


def row_dim(cfg: dict) -> int:
    return 1 + int(cfg["factor_num"])


def accum_width(cfg: dict) -> int:
    return row_dim(cfg) if cfg["adagrad_accumulator"] == "element" else 1


def _chunk_generator(seed: int, chunk: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, 1000 + chunk))


def _fill_chunk(out: torch.Tensor, r: float, gen: torch.Generator) -> torch.Tensor:
    out.uniform_(-r, r, generator=gen)
    out[:, 0] = 0.0
    return out


def draw_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """The starting table [V, D] float32 on ``device``."""
    v, d, r = int(cfg["vocabulary_size"]), row_dim(cfg), float(cfg["init_value_range"])
    table = torch.empty((v, d), dtype=torch.float32, device=device)
    for c, lo in enumerate(range(0, v, TABLE_CHUNK_ROWS)):
        _fill_chunk(table[lo:lo + TABLE_CHUNK_ROWS], r, _chunk_generator(seed, c, device))
    return table


def initial_rows(cfg: dict, seed: int, rows: torch.Tensor, device) -> torch.Tensor:
    """``draw_table``'s rows ``rows`` (sorted int64), drawn again chunk by
    chunk on ``device`` without the whole table."""
    v, d, r = int(cfg["vocabulary_size"]), row_dim(cfg), float(cfg["init_value_range"])
    rows = rows.to(device)
    out = torch.empty((rows.numel(), d), dtype=torch.float32, device=device)
    for c, lo in enumerate(range(0, v, TABLE_CHUNK_ROWS)):
        hi = min(lo + TABLE_CHUNK_ROWS, v)
        a, b = torch.searchsorted(rows, torch.tensor([lo, hi], device=device)).tolist()
        if a == b:
            continue
        chunk = _fill_chunk(torch.empty((hi - lo, d), dtype=torch.float32, device=device), r,
                            _chunk_generator(seed, c, device))
        out[a:b] = chunk[rows[a:b] - lo]
        del chunk
    return out


def draw_dense(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The starting dense leaves by name: He-initialised weights ``w{i}``
    [d_in, d_out], zero biases ``b{i}``, drawn in layer order."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    out = {}
    for name, shape in model_module(cfg).dense_shapes(cfg).items():
        if name.startswith("w"):
            w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
            out[name] = w * (2.0 / shape[0]) ** 0.5
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def config_precision(cfg: dict) -> Precision:
    return Precision(torch.float32, "bf16" if cfg.get("compute_dtype") == "bfloat16" else "none")


def lower_precision(cfg: dict) -> Precision:
    """One step below what the configuration states: bfloat16 for float32
    arithmetic, fp8 (e4m3, one scale per tensor) for bfloat16 operands."""
    return Precision(torch.bfloat16, "fp8" if cfg.get("compute_dtype") == "bfloat16" else "bf16")


def lower_mlp_precision(cfg: dict) -> Precision | None:
    """The MLP's operands alone one step below what the configuration
    states (fp8 for bfloat16), every other sum as stated; None where the
    configuration has no bfloat16 MLP."""
    if cfg.get("compute_dtype") != "bfloat16":
        return None
    return Precision(torch.float32, "fp8")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().max().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Round(torch.autograd.Function):
    """fp8 rounding with a per-tensor scale; its backward rounds the
    gradient the same way."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def round_operand(x: torch.Tensor, kind: str) -> torch.Tensor:
    """A float32 matmul operand rounded as ``kind`` says, held as float32.
    bf16: the cast and back, whose backward rounds the gradient to
    bfloat16 at the same point."""
    x = x.float()
    if kind == "none":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        return _Fp8Round.apply(x)
    raise ValueError(f"unknown operand rounding {kind!r}")


def logistic_loss(scores, labels, weights):
    """Weighted mean sigmoid cross-entropy, softplus(s) - s·y, whose
    gradient is sigmoid(s) - y at every score."""
    per = torch.nn.functional.softplus(scores) - scores * labels
    return torch.sum(per * weights) / torch.clamp_min(torch.sum(weights), 1.0)


def masked_l2(rows, vals, bias_lambda: float, factor_lambda: float):
    """L2 over every gathered occurrence whose value is not 0."""
    m = (vals != 0).to(rows.dtype)[..., None]
    masked = rows * m
    return bias_lambda * torch.sum(masked[..., 0] ** 2) + factor_lambda * torch.sum(masked[..., 1:] ** 2)


def _adagrad(param, accum, grad, lr: float) -> None:
    """In place: accum += g² (a [n, 1] accumulator: the row's ‖g‖²),
    param -= lr·g/√accum."""
    sq = grad * grad
    if accum.shape[-1] == 1 and grad.dim() == 2 and grad.shape[-1] != 1:
        sq = sq.sum(-1, keepdim=True)
    accum += sq
    param -= lr * grad / torch.sqrt(accum)


def reference_steps(cfg: dict, batches: list[dict], seed: int, device, prec: Precision,
                    keep, fault: str | None = None) -> dict:
    """Follow the first ``len(batches)`` training steps from the
    benchmark's starting weights.  Returns the rows every batch touches
    (``ck``, sorted), the starting leaves (``table0`` rows of ``ck``,
    ``dense0``), each step's data loss, the first step's gradients as the
    optimizer takes them (``grad1``: the table's summed per row of ``ck``,
    and the dense leaves'), and the state after each step count in
    ``keep`` (``snaps``).

    ``fault`` plants a fault in the reference, for reading what the
    comparison gives a broken program: ``half_batch`` leaves out the
    second half of every batch and takes the mean over the rest;
    ``unchanged`` returns the state unchanged from every step."""
    mod = model_module(cfg)
    lr = float(cfg["learning_rate"])
    dt = prec.dtype
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ck = torch.unique(torch.cat([b["ids"].reshape(-1) for b in batches]).to(device).long())
        table0 = initial_rows(cfg, seed, ck, device)
        dense0 = draw_dense(cfg, seed, device)
        table = table0.clone()
        accum = torch.full((ck.numel(), accum_width(cfg)), float(cfg["init_accumulator_value"]),
                           device=device)
        dense = {k: v.clone() for k, v in dense0.items()}
        dense_accum = {k: torch.full_like(v, float(cfg["init_accumulator_value"]))
                       for k, v in dense.items()}
        names = list(dense)
        losses, snaps, grad1 = [], {}, None
        for t, b in enumerate(batches, 1):
            cid = torch.searchsorted(ck, b["ids"].to(device).long())
            vals = b["vals"].to(device)
            weights = b["weights"].to(device)
            if fault == "half_batch":
                weights = weights.clone()
                weights[weights.shape[0] // 2:] = 0.0
            rows = table[cid].requires_grad_(True)
            leaves = [dense[k].detach().requires_grad_(True) for k in names]
            scores = mod.score(rows, vals, dict(zip(names, leaves)), cfg, prec)
            data_loss = logistic_loss(scores.to(dt), b["labels"].to(device).to(dt), weights.to(dt))
            reg = masked_l2(rows.to(dt), vals.to(dt), float(cfg["bias_lambda"]),
                            float(cfg["factor_lambda"]))
            g_rows, *g_dense = torch.autograd.grad(data_loss + reg, [rows, *leaves])
            d = table.shape[1]
            gsum = torch.zeros((ck.numel(), d), dtype=torch.float64, device=device)
            gsum.index_add_(0, cid.reshape(-1), g_rows.reshape(-1, d).double())
            gsum = gsum.float()
            if t == 1:
                grad1 = {"table": gsum.clone(), **{k: g.float().clone() for k, g in zip(names, g_dense)}}
            if fault != "unchanged":
                with torch.no_grad():
                    touched = torch.bincount(cid.reshape(-1), minlength=ck.numel()).nonzero().squeeze(1)
                    t_rows, a_rows = table[touched], accum[touched]
                    _adagrad(t_rows, a_rows, gsum[touched], lr)
                    table[touched], accum[touched] = t_rows, a_rows
                    for k, g in zip(names, g_dense):
                        _adagrad(dense[k], dense_accum[k], g.float(), lr)
            losses.append(float(data_loss.detach()))
            if t in keep:
                snaps[t] = {
                    "table": table.detach().clone(), "accum": accum.clone(),
                    "dense": {k: v.detach().clone() for k, v in dense.items()},
                    "dense_accum": {k: v.clone() for k, v in dense_accum.items()},
                }
        return {"ck": ck, "table0": table0, "dense0": dense0, "losses": losses, "grad1": grad1,
                "snaps": snaps}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
