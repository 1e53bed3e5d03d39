#!/usr/bin/env python
"""Held-out-AUC data-scaling study of the PyTorch/CUDA port — the
counterpart of ``tools/scaling_study.py`` on ``fast_tffm_tpu_torch``, with
its task, constants, seeds and defaults.

Each point: generate a train split (the fixed test split is 50k rows at
seed 1), train the port's ``training.train`` with binary_cache, record the
best validation AUC from the JSONL metrics, report it against the oracle
AUC (the planted model scoring the same held-out rows, parsed by the
port's native parser).  Each split's text and ``.fmb`` are removed as the
study goes, as the JAX tool does.  The files are ``gen_synthetic.generate``'s
bytes, written by ``tools/torch_gen_synthetic.py``.  The run goes on
``--device`` (the card unless ``--device cpu``; without a card it raises).

The artifact's keys are the JAX tool's plus ``ADDED_KEYS``: the device
stamp (``device``, ``device_name``, ``card``: ``nvidia-smi``'s name and
power limit, ``torch_version``, ``cuda_version``), ``kernel_launches`` (the
kernel wrappers' counts over the run) and ``reduced`` (the default points
left out and an epoch count below the default; empty at the defaults).

Usage:
  python tools/torch_scaling_study.py [--rows 2400000,4800000,9600000]
      [--epochs 4] [--out SCALING_STUDY_TORCH_r17.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tools import torch_gen_synthetic  # noqa: E402
from tools.gen_synthetic import planted_score  # noqa: E402
from tools.torch_quality_zoo import ADDED_KEYS, run_stamp  # noqa: E402,F401

FIELDS, K_HIDDEN, SPREAD, VOCAB = 39, 4, 3.0, 1 << 14
DEFAULT_ROWS = "2400000,4800000,9600000"


def generate(out: str, rows: int, seed: int) -> None:
    """``gen_synthetic.generate(out, rows, FIELDS, VOCAB, seed=seed,
    factor_num=K_HIDDEN, spread=SPREAD)``: the same file."""
    torch_gen_synthetic.generate(out, rows, FIELDS, VOCAB, factor_num=K_HIDDEN, seed=seed,
                                 spread=SPREAD)


def oracle_auc(path):
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.metrics import auc

    labels, scores = [], []
    for b, w in batch_stream(
        [path], batch_size=8192, vocabulary_size=VOCAB, max_nnz=FIELDS,
        parser=best_parser(),
    ):
        n = int((w > 0).sum())
        scores.append(planted_score(np.asarray(b.ids)[:n], b.vals[:n], factor_num=K_HIDDEN))
        labels.append(b.labels[:n])
    return auc(np.concatenate(labels), np.concatenate(scores))


def train_config(td, rows, tr, te, epochs, lr, bs):
    """The JAX tool's ``train_point`` config, as the port's Config."""
    from fast_tffm_tpu_torch.config import Config

    return Config(
        model="fm",
        factor_num=8,
        vocabulary_size=VOCAB,
        model_file=os.path.join(td, f"m_{rows}.ckpt"),
        train_files=(tr,),
        validation_files=(te,),
        epoch_num=epochs,
        batch_size=bs,
        learning_rate=lr,
        log_every=10**9,
        metrics_path=os.path.join(td, f"metrics_{rows}.jsonl"),
        binary_cache=True,
    ).validate()


def train_point(td, rows, te, epochs, lr, bs, device):
    from fast_tffm_tpu_torch.training import train

    tr = os.path.join(td, f"tr_{rows}.libsvm")
    t0 = time.time()
    generate(tr, rows, seed=0)
    gen_secs = time.time() - t0
    cfg = train_config(td, rows, tr, te, epochs, lr, bs)
    t0 = time.time()
    train(cfg, log=lambda *_: None, device=device)
    train_secs = time.time() - t0
    with open(cfg.metrics_path) as f:
        aucs = [r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r]
    # Free the big splits as we go (10M rows of text+fmb is ~10 GB).
    for suffix in ("", ".fmb"):
        try:
            os.remove(tr + suffix)
        except OSError:
            pass
    return max(aucs), {"gen_secs": round(gen_secs, 1), "train_secs": round(train_secs, 1)}


def main(argv=None) -> int:
    from fast_tffm_tpu_torch.device import resolve_device
    from fast_tffm_tpu_torch.telemetry import write_json_artifact

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=DEFAULT_ROWS)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING_STUDY_TORCH_r17.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    wanted = [int(r) for r in args.rows.split(",")]

    points = []
    with tempfile.TemporaryDirectory() as td:
        te = os.path.join(td, "te.libsvm")
        generate(te, 50_000, seed=1)
        oracle = oracle_auc(te)
        print(json.dumps({"oracle_auc": round(oracle, 5)}), flush=True)
        for rows in wanted:
            auc_v, timing = train_point(td, rows, te, args.epochs, args.lr, args.batch, device)
            point = {
                "rows": rows,
                "heldout_auc": round(auc_v, 5),
                "oracle_auc": round(oracle, 5),
                "gap": round(oracle - auc_v, 5),
                "lift_vs_oracle": round((auc_v - 0.5) / (oracle - 0.5), 4),
                **timing,
            }
            points.append(point)
            print(json.dumps(point), flush=True)

    reduced = {}
    left_out = [r for r in map(int, DEFAULT_ROWS.split(",")) if r not in wanted]
    if left_out:
        reduced["rows"] = {"default": DEFAULT_ROWS, "run": args.rows, "left_out": left_out}
    if args.epochs < ap.get_default("epochs"):
        reduced["epochs"] = {"default": ap.get_default("epochs"), "run": args.epochs}
    artifact = {
        "study": "held-out AUC vs training rows (planted Zipf CTR task, "
        f"FM k=8, vocab=2^14, {FIELDS} fields, spread={SPREAD}, "
        f"epochs={args.epochs}, lr={args.lr}, batch={args.batch})",
        "r1_points": [
            {"rows": 150_000, "heldout_auc": 0.649},
            {"rows": 600_000, "heldout_auc": 0.712},
            {"rows": 2_400_000, "heldout_auc": 0.826},
        ],
        "points": points,
        **run_stamp(device),
        "reduced": reduced,
    }
    write_json_artifact(args.out, artifact, sort_keys=False)
    print(json.dumps({"written": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
