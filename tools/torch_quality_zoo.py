#!/usr/bin/env python
"""Model-zoo convergence artifacts of the PyTorch/CUDA port: held-out AUC
against a planted-oracle ceiling — the counterpart of
``tools/quality_zoo.py`` on ``fast_tffm_tpu_torch``, with its constants,
seeds, per-family budgets and data bytes.

Each family trains through the port's ``training.train`` on planted-model
synthetic data whose generating process matches it:

  ffm     planted field-aware factors (v[id, partner_field, k]); libffm
          input; config #3's model class
  fm3     planted order-3 FM (linear + ANOVA_2 + ANOVA_3); config #5's
          model class (kernels B1 and B2 on the card)
  deepfm  planted FM signal plus a tanh-pooled nonlinearity no plain FM
          can represent; trains both deepfm and fm on the same rows
          (config #4's model class)

Each row reports the best validation AUC from the run's JSONL metrics next
to the ORACLE ceiling (the planted model scoring the same held-out rows).
The run goes on ``--device`` (the card unless ``--device cpu``; without a
card it raises).

The artifact's keys are the JAX tool's plus ``ADDED_KEYS``: the device
stamp (``device``, ``device_name``, ``card``: ``nvidia-smi``'s name and
power limit, ``torch_version``, ``cuda_version``), ``kernel_launches`` (the
kernel wrappers' counts over the run) and ``reduced`` (each size below the
tool's default: {argument: {"default", "run"}}; empty at the defaults).

Usage: python tools/torch_quality_zoo.py [--rows 2400000] [--epochs 6] [--quick]
                                         [--families ffm,fm3,deepfm] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tools.gen_synthetic import _id_normal, _zipf_ids, planted_score  # noqa: E402
from tools.torch_gen_synthetic import write_rows  # noqa: E402

VOCAB = 1 << 12
# Vocab 4096, not the FM study's 2^14: FFM learns F·k = 32 factor params
# per id (8× plain FM), so matching the study's observations-per-PARAMETER
# at a budget-sized row count needs proportionally more observations per
# id (the JAX tool's rationale).
K = 4
SPREAD = 2.2  # label noise calibration (gen_synthetic rationale)
ADDED_KEYS = ("device", "device_name", "card", "torch_version", "cuda_version",
              "kernel_launches", "reduced")


def _draw_rows(rng, rows: int, fields: int):
    bounds = np.linspace(0, VOCAB, fields + 1).astype(np.int64)
    ids = np.stack(
        [_zipf_ids(rng, rows, bounds[f], bounds[f + 1]) for f in range(fields)],
        axis=1,
    )
    vals = np.round(
        np.abs(rng.normal(0.5, 0.35, size=(rows, fields))) + 0.05, 4
    ).astype(np.float32)
    return ids, vals


def planted_ffm_score(ids, vals, fields: int, seed: int = 777):
    """bias + Σ_{a<b} <v(id_a, b), v(id_b, a)> x_a x_b, v planted per
    (id, partner_field, k) via the stateless hash-normal; chunked over rows
    (the [rows, F, F, K] factor tensor at 2.4M rows would be ~2.4 GB×2)."""
    rows = ids.shape[0]
    bias = 0.5 * _id_normal(ids, seed)
    score = (bias * vals).sum(axis=1)
    chunk = 200_000
    for lo in range(0, rows, chunk):
        hi = min(lo + chunk, rows)
        cid, cv = ids[lo:hi], vals[lo:hi]
        fac = np.zeros((hi - lo, fields, fields, K), np.float32)
        for g in range(fields):
            for j in range(K):
                fac[:, :, g, j] = 0.55 * _id_normal(cid, seed + 13 + g * K + j)
        zx = fac * cv[..., None, None]  # [chunk, i, g, k]
        for a in range(fields):
            for b in range(a + 1, fields):
                score[lo:hi] += np.einsum("rk,rk->r", zx[:, a, b], zx[:, b, a])
    return score


def planted_fm3_score(ids, vals, seed: int = 888):
    """linear + ANOVA_2 + ANOVA_3 over planted v[id, k] (elementary
    symmetric polynomials per factor dim: the order-3 FM's semantics)."""
    bias = 0.5 * _id_normal(ids, seed)
    v = np.stack(
        [0.5 * _id_normal(ids, seed + 7 + j) for j in range(K)], axis=-1
    )
    z = v * vals[..., None]  # [rows, n, k]
    s1 = z.sum(axis=1)
    s2 = (z * z).sum(axis=1)
    s3 = (z * z * z).sum(axis=1)
    e2 = 0.5 * (s1 * s1 - s2)
    e3 = (s1**3 - 3 * s1 * s2 + 2 * s3) / 6.0
    return (bias * vals).sum(axis=1) + (e2 + e3).sum(axis=-1)


def planted_deep_score(ids, vals, seed: int = 999):
    """Planted FM score + a tanh-pooled term: s += Σ_j w_j tanh(1.5 p_j),
    p = Σ_i u(id_i) x_i — outside the FM function class, so the MLP head
    has genuine signal to capture."""
    base = planted_score(ids, vals, factor_num=K, model_seed=seed)
    u = np.stack(
        [0.6 * _id_normal(ids, seed + 101 + j) for j in range(K)], axis=-1
    )
    p = (u * vals[..., None]).sum(axis=1)  # [rows, k]
    w = np.array([1.7, -1.3, 1.1, -0.9], np.float32)[:K]
    return base + 1.6 * np.tanh(1.5 * p) @ w


def _labels(rng, score):
    s = (score - score.mean()) / (score.std() + 1e-6) * SPREAD
    return (rng.random(s.shape[0]) < 1.0 / (1.0 + np.exp(-s))).astype(np.int64), s


def _gen_split(tmp, tag, scorer, fields, rows, seed, fmt):
    rng = np.random.default_rng(seed)
    ids, vals = _draw_rows(rng, rows, fields)
    labels, s = _labels(rng, scorer(ids, vals))
    path = os.path.join(tmp, f"{tag}.{fmt}")
    write_rows(path, labels, ids, vals, fmt)
    return path, labels, s


def train_config(tmp, tag, train_file, test_file, *, model, fields, epochs, order=2,
                 hidden=(), lr=0.1):
    """The JAX tool's ``_train`` config, as the port's Config."""
    from fast_tffm_tpu_torch.config import Config

    return Config(
        model=model, factor_num=K, vocabulary_size=VOCAB, order=order,
        num_fields=fields if model in ("ffm", "deepfm") else 0,
        hidden_dims=tuple(hidden),
        model_file=os.path.join(tmp, f"m_{tag}.npz"),
        train_files=(train_file,), validation_files=(test_file,),
        epoch_num=epochs, batch_size=8192, learning_rate=lr,
        init_accumulator_value=0.1, log_every=200, binary_cache=True,
        metrics_path=os.path.join(tmp, f"jl_{tag}.jsonl"),
    ).validate()


def best_validation_auc(metrics_path: str) -> float:
    with open(metrics_path) as f:
        return max(r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r)


def _train(tmp, tag, train_file, test_file, *, device, resume=False, **kw):
    from fast_tffm_tpu_torch.training import train

    cfg = train_config(tmp, tag, train_file, test_file, **kw)
    train(cfg, resume=resume, log=lambda *_: None, device=device)
    return best_validation_auc(cfg.metrics_path)


def reduced_sizes(args, defaults: dict) -> dict:
    """Each size argument below its default: {name: {"default", "run"}}."""
    return {k: {"default": d, "run": getattr(args, k)} for k, d in defaults.items()
            if getattr(args, k) < d}


def run_stamp(device) -> dict:
    """The port's additions to an artifact: the device stamp and the kernel
    wrappers' launch counts in this process."""
    from fast_tffm_tpu_torch.serving.replica import launch_counts
    from fast_tffm_tpu_torch.telemetry import device_stamp

    return {**device_stamp(device), "kernel_launches": launch_counts()}


def main(argv=None) -> int:
    from fast_tffm_tpu_torch.device import resolve_device
    from fast_tffm_tpu_torch.metrics import auc
    from fast_tffm_tpu_torch.telemetry import write_json_artifact

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=2_400_000)
    ap.add_argument("--test-rows", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes for a smoke run")
    ap.add_argument("--families", default="ffm,fm3,deepfm",
                    help="comma list: ffm,fm3,deepfm (skip the rest)")
    ap.add_argument("--out", default=os.path.join(REPO, "QUALITY_ZOO_TORCH_r17.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    defaults = {k: ap.get_default(k) for k in ("rows", "test_rows", "epochs")}
    if args.quick:
        args.rows, args.test_rows, args.epochs = 60_000, 8_000, 2
    device = resolve_device(args.device)

    # Per-family budgets (the JAX tool's): the interaction-only families get
    # more passes and a hotter lr, DeepFM's MLP head a few extra epochs;
    # under --quick everything keeps the smoke budget.
    budget = {
        "ffm": (args.epochs if args.quick else args.epochs + 10, 0.25),
        "fm3": (args.epochs if args.quick else args.epochs + 10, 0.25),
        "deepfm": (args.epochs if args.quick else args.epochs + 4, 0.05),
        "fmbase": (args.epochs, 0.1),
    }

    wanted = set(args.families.split(","))
    res = {"rows": args.rows, "test_rows": args.test_rows,
           "base_epochs": args.epochs,
           "vocab": VOCAB, "k": K, "families": {}}
    with tempfile.TemporaryDirectory() as tmp:
        if "ffm" in wanted:
            F = 8
            tr, _, _ = _gen_split(tmp, "ffm_tr", lambda i, v: planted_ffm_score(i, v, F),
                                  F, args.rows, 10, "libffm")
            te, te_labels, te_score = _gen_split(
                tmp, "ffm_te", lambda i, v: planted_ffm_score(i, v, F),
                F, args.test_rows, 11, "libffm")
            ep, lr = budget["ffm"]
            learned = _train(tmp, "ffm", tr, te, device=device, model="ffm", fields=F,
                             epochs=ep, lr=lr)
            res["families"]["ffm"] = {
                "heldout_auc": round(float(learned), 5),
                "oracle_auc": round(float(auc(te_labels, te_score)), 5),
                "epochs": ep, "lr": lr,
            }
            print("ffm ->", res["families"]["ffm"], flush=True)

        if "fm3" in wanted:
            F = 12
            tr, _, _ = _gen_split(tmp, "fm3_tr", planted_fm3_score, F, args.rows,
                                  20, "libsvm")
            te, te_labels, te_score = _gen_split(
                tmp, "fm3_te", planted_fm3_score, F, args.test_rows, 21, "libsvm")
            ep, lr = budget["fm3"]
            learned = _train(tmp, "fm3", tr, te, device=device, model="fm", fields=0,
                             epochs=ep, order=3, lr=lr)
            res["families"]["fm3"] = {
                "heldout_auc": round(float(learned), 5),
                "oracle_auc": round(float(auc(te_labels, te_score)), 5),
                "epochs": ep, "lr": lr,
            }
            print("fm3 ->", res["families"]["fm3"], flush=True)

        if "deepfm" in wanted:
            F = 12
            tr, _, _ = _gen_split(tmp, "deep_tr", planted_deep_score, F, args.rows,
                                  30, "libsvm")
            te, te_labels, te_score = _gen_split(
                tmp, "deep_te", planted_deep_score, F, args.test_rows, 31, "libsvm")
            ep, lr = budget["deepfm"]
            bep, blr = budget["fmbase"]
            deep = _train(tmp, "deepfm", tr, te, device=device, model="deepfm", fields=F,
                          epochs=ep, hidden=(64, 32), lr=lr)
            plain = _train(tmp, "fmbase", tr, te, device=device, model="fm", fields=0,
                           epochs=bep, lr=blr)
            res["families"]["deepfm"] = {
                "heldout_auc": round(float(deep), 5),
                "fm_baseline_auc": round(float(plain), 5),
                "oracle_auc": round(float(auc(te_labels, te_score)), 5),
                "lift_over_fm": round(float(deep - plain), 5),
                "epochs": ep, "lr": lr,
                "fm_baseline_epochs": bep, "fm_baseline_lr": blr,
            }
            print("deepfm ->", res["families"]["deepfm"], flush=True)

    res.update(run_stamp(device))
    res["reduced"] = reduced_sizes(args, defaults)
    write_json_artifact(args.out, res, sort_keys=False)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
