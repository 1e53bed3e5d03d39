#!/usr/bin/env python
"""Synthetic CTR text of the PyTorch/CUDA port's tools: ``tools/gen_synthetic.py``'s
files, byte for byte, written a block of rows at a time.

``generate`` makes ``gen_synthetic.generate``'s draws (its ``_zipf_ids`` and
``planted_score``, imported from it; the planted score taken in row blocks,
each row's the same bits as one call over every row) and ``write_rows``
formats them a place of digits at a time over a block of rows instead of
one token at a time; ``write_rows`` is also the text writer of
``tools/torch_quality_zoo.py``, ``tools/torch_scaling_study.py`` and
``tools/torch_backtest.py`` (the JAX tools' ``_write``).  The command line is ``gen_synthetic.py``'s:

  python tools/torch_gen_synthetic.py --rows 100000 --fields 39 --vocab 1048576 \\
      --out data/criteo_sample.train.libsvm
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tools.gen_synthetic import _zipf_ids, planted_score  # noqa: E402

# Rows formatted per block, and rows scored per block.
WRITE_CHUNK = SCORE_CHUNK = 1 << 16


def _digits(x: np.ndarray, width: int, pad: bool = False) -> np.ndarray:
    """Non-negative ints as [n, width] ASCII digits, right-aligned, the
    leading places 0 bytes (dropped when a block is joined) unless ``pad``
    keeps them as zeros."""
    out = np.empty((x.shape[0], width), np.uint8)
    rem = x
    for p in range(width - 1, -1, -1):
        q = rem // 10
        d = (rem - q * 10 + ord("0")).astype(np.uint8)
        out[:, p] = d if pad or p == width - 1 else np.where(rem > 0, d, 0)
        rem = q
    return out


def _value_text(ticks: np.ndarray, width: int) -> np.ndarray:
    """Ticks of 1e-4 as ``f"{ticks / 1e4:.4f}"``: whole part, ".", 4 places."""
    dot = np.full((ticks.shape[0], 1), ord("."), np.uint8)
    return np.concatenate([_digits(ticks // 10_000, max(width - 4, 1)), dot,
                           _digits(ticks % 10_000, 4, pad=True)], axis=1)


def write_rows(path, labels, ids, vals, fmt: str) -> None:
    """``f"{label} "`` and, per field, ``f"{id}:{val:.4f}"`` (libffm:
    ``f"{field}:{id}:{val:.4f}"``) joined by spaces, one row a line: the JAX
    tools' bytes.  Labels, ids and values are non-negative and the values on
    the 4-decimal grid the tools round them to (both checked)."""
    labels = np.asarray(labels, np.int64)
    ids = np.asarray(ids, np.int64)
    ticks = np.rint(vals.astype(np.float64) * 10_000).astype(np.int64)
    if min(labels.min(initial=0), ids.min(initial=0), ticks.min(initial=0)) < 0:
        raise ValueError("write_rows takes non-negative labels, ids and values")
    # Within a quarter tick of the grid, ``rint`` and the f-string's rounding
    # of the exact value pick the same tick.
    if np.abs(vals.astype(np.float64) * 10_000 - ticks).max(initial=0.0) > 0.25:
        raise ValueError("write_rows takes values rounded to 4 decimals")
    fields = ids.shape[1]
    seps = [np.frombuffer((f" {fi}:" if fmt == "libffm" else " ").encode(), np.uint8)
            for fi in range(fields)]
    colon = np.frombuffer(b":", np.uint8)
    lw, iw = (len(str(int(x.max(initial=0)))) for x in (labels, ids))
    tw = len(str(int(ticks.max(initial=0))))
    vw = max(tw - 4, 1) + 5
    row = lw + sum(s.size for s in seps) + fields * (iw + 1 + vw) + 1
    with open(path, "wb") as f:
        for lo in range(0, ids.shape[0], WRITE_CHUNK):
            hi = min(lo + WRITE_CHUNK, ids.shape[0])
            out = np.empty((hi - lo, row), np.uint8)
            out[:, :lw] = _digits(labels[lo:hi], lw)
            c = lw
            for fi, sep in enumerate(seps):
                for piece in (sep, _digits(ids[lo:hi, fi], iw), colon,
                              _value_text(ticks[lo:hi, fi], tw)):
                    w = piece.shape[-1]
                    out[:, c:c + w] = piece
                    c += w
            out[:, c] = ord("\n")
            flat = out.ravel()
            f.write(flat[flat != 0].tobytes())


def generate(
    out: str,
    rows: int,
    fields: int,
    vocab: int,
    fmt: str = "libsvm",
    factor_num: int = 4,
    seed: int = 0,
    binary_vals: bool = False,
    model_seed: int = 1234,
    spread: float = 1.5,
) -> None:
    """``gen_synthetic.generate`` with the same arguments: the same file."""
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, vocab, fields + 1).astype(np.int64)
    ids = np.stack(
        [_zipf_ids(rng, rows, bounds[f], bounds[f + 1]) for f in range(fields)], axis=1)
    vals = (
        np.ones((rows, fields), np.float32)
        if binary_vals
        else np.round(np.abs(rng.normal(0.5, 0.35, size=(rows, fields))) + 0.05, 4).astype(
            np.float32)
    )
    score = np.concatenate(
        [planted_score(ids[lo:lo + SCORE_CHUNK], vals[lo:lo + SCORE_CHUNK], factor_num, model_seed)
         for lo in range(0, rows, SCORE_CHUNK)])
    score = (score - score.mean()) / (score.std() + 1e-6) * spread
    labels = (rng.random(rows) < 1.0 / (1.0 + np.exp(-score))).astype(np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    write_rows(out, labels, ids, vals, fmt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output text file")
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--fields", type=int, default=39, help="features per example")
    ap.add_argument("--vocab", type=int, default=1 << 20)
    ap.add_argument("--format", choices=("libsvm", "libffm"), default="libsvm")
    ap.add_argument("--factor-num", type=int, default=4, help="hidden FM rank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--binary-vals", action="store_true", help="all feature values 1.0 (one-hot style)"
    )
    ap.add_argument(
        "--model-seed", type=int, default=1234,
        help="seed of the PLANTED model (keep equal across train/valid/test splits)",
    )
    ap.add_argument(
        "--spread", type=float, default=1.5,
        help="planted score std; bigger = less label noise, higher oracle AUC",
    )
    a = ap.parse_args(argv)
    generate(a.out, a.rows, a.fields, a.vocab, a.format, a.factor_num, a.seed, a.binary_vals,
             a.model_seed, a.spread)
    print(f"wrote {a.rows} rows ({a.fields} fields, vocab {a.vocab}, {a.format}) -> {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
