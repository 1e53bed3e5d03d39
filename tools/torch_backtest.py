#!/usr/bin/env python
"""Rolling quality backtest of the PyTorch/CUDA port: replay a drifting
day, online against batch-retrain — the counterpart of ``tools/backtest.py``
on ``fast_tffm_tpu_torch``, with its constants, seeds, data and stream
bytes, and gate.

  * a synthetic DAY of events whose planted FM drifts hour by hour (a
    60-degree rotation between two planted parameter sets);
  * the ONLINE trainer consumes the day as an append-only FMS stream
    (``data.stream.StreamWriter``) through the port's ``training.train``
    under ``[Online] follow``: hour h's rows are appended, then the trainer
    resumes and follows up to its ``online_max_batches`` bound, so every
    hour boundary resumes at the exact mid-stream cursor;
  * the BATCH reference retrains from scratch each hour on all data so far;
  * after each hour both models score the NEXT hour's held-out rows
    (restore → predict step → streaming AUC) and one ``kind=quality``
    record lands in the online run's telemetry JSONL.

``tools/report.py`` (stdlib only) then compares the online run against
the batch reference, strict; the artifact's gate is the JAX tool's, and
the exit code is nonzero when it fails.  The runs go on ``--device`` (the
card unless ``--device cpu``; without a card it raises).

The artifact's keys are the JAX tool's plus ``ADDED_KEYS``: the device
stamp (``device``, ``device_name``, ``card``: ``nvidia-smi``'s name and
power limit, ``torch_version``, ``cuda_version``), ``kernel_launches`` (the
kernel wrappers' counts over the run) and ``reduced`` (each size below the
tool's default: {argument: {"default", "run"}}; empty at the defaults).

Usage:
    python tools/torch_backtest.py [--hours 24] [--rows-per-hour 4096] [--quick]
        [--decay 0.999] [--batch-epochs 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from tools.gen_synthetic import planted_score  # noqa: E402
from tools.torch_gen_synthetic import write_rows  # noqa: E402
from tools.torch_quality_zoo import (  # noqa: E402,F401
    ADDED_KEYS,
    VOCAB,
    _draw_rows,
    reduced_sizes,
    run_stamp,
)

FIELDS = 8
K = 4
SPREAD = 2.2  # label-noise calibration (quality_zoo rationale)


def drifted_score(ids, vals, hour: int, hours: int):
    """s_h = cos(θ_h)·s_A + sin(θ_h)·s_B, θ sweeping 60° over the day: a
    pure function of (ids, vals, hour), so train and held-out splits share
    the hour's model exactly."""
    theta = (hour / max(1, hours - 1)) * (np.pi / 3.0)
    s_a = planted_score(ids, vals, factor_num=K, model_seed=4242)
    s_b = planted_score(ids, vals, factor_num=K, model_seed=8383)
    return np.cos(theta) * s_a + np.sin(theta) * s_b


def _labels(rng, score):
    s = (score - score.mean()) / (score.std() + 1e-6) * SPREAD
    return (rng.random(s.shape[0]) < 1.0 / (1.0 + np.exp(-s))).astype(np.int64)


def _gen_hour(hour: int, hours: int, rows: int, seed: int):
    rng = np.random.default_rng((seed, hour))
    ids, vals = _draw_rows(rng, rows, FIELDS)  # the zoo's draws at VOCAB 4,096
    labels = _labels(rng, drifted_score(ids, vals, hour, hours))
    return labels, ids, vals


def _auc_on(cfg, heldout_file: str, max_nnz: int, device) -> float:
    """Held-out AUC of cfg.model_file's CURRENT checkpoint on one file,
    through the port's restore + predict step + streaming AUC."""
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.trainer import make_predict_step
    from fast_tffm_tpu_torch.training import _evaluate

    model = build_model(cfg)
    state = restore_checkpoint(cfg.model_file, device, n_dense=len(model.dense_names))
    return _evaluate(cfg, model, make_predict_step(model), state, (heldout_file,), max_nnz,
                     device, lambda *_: None)


def online_config(tmp, stream_path, max_batches, args, run_id):
    """The JAX tool's ``online_cfg``, as the port's Config."""
    from fast_tffm_tpu_torch.config import Config

    return Config(
        model="fm", factor_num=K, vocabulary_size=VOCAB,
        model_file=os.path.join(tmp, "m_online.npz"),
        train_files=(stream_path,),
        epoch_num=1, batch_size=args.batch_size, max_nnz=FIELDS,
        # Low enough that one hour's handful of batches still emits a
        # kind=train record.
        learning_rate=args.lr, log_every=4,
        online_follow=True, online_max_batches=max_batches,
        online_poll_s=0.05, online_idle_timeout_s=30.0,
        online_adagrad_decay=args.decay,
        metrics_path=os.path.join(tmp, "online.jsonl"), telemetry_run_id=run_id,
    ).validate()


def batch_config(tmp, hour_files, args, run_id):
    """The JAX tool's ``batch_cfg``, as the port's Config."""
    from fast_tffm_tpu_torch.config import Config

    return Config(
        model="fm", factor_num=K, vocabulary_size=VOCAB,
        model_file=os.path.join(tmp, "m_batch.npz"),
        train_files=tuple(hour_files),
        epoch_num=args.batch_epochs, batch_size=args.batch_size,
        max_nnz=FIELDS, learning_rate=args.lr, log_every=50,
        binary_cache=True,
        metrics_path=os.path.join(tmp, "batch.jsonl"), telemetry_run_id=run_id,
    ).validate()


def _report_tool():
    """tools/report.py, loaded by path (stdlib only; no package)."""
    spec = importlib.util.spec_from_file_location(
        "report_tool", os.path.join(os.path.dirname(os.path.abspath(__file__)), "report.py"))
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    return report


def main(argv=None) -> int:
    from fast_tffm_tpu_torch.telemetry import arm_hang_exit

    hang_timer = arm_hang_exit(3600, what="backtest")
    try:
        return _main(argv)
    finally:
        hang_timer.cancel()


def _main(argv) -> int:
    from fast_tffm_tpu_torch.data.stream import StreamWriter
    from fast_tffm_tpu_torch.device import resolve_device
    from fast_tffm_tpu_torch.telemetry import (
        RunMonitor,
        artifact_stamp,
        new_run_id,
        write_json_artifact,
    )
    from fast_tffm_tpu_torch.training import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=int, default=24, help="replayed 'day' length")
    ap.add_argument("--rows-per-hour", type=int, default=4096)
    ap.add_argument("--heldout-rows", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--decay", type=float, default=1.0,
                    help="[Online] adagrad_decay for the online trainer")
    ap.add_argument("--batch-epochs", type=int, default=1,
                    help="epochs per batch-retrain reference run")
    ap.add_argument("--threshold", type=float, default=0.05,
                    help="max tolerated (batch - online) held-out AUC gap")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--quick", action="store_true",
                    help="tiny smoke shapes (3 hours)")
    ap.add_argument("--keep-dir", default=None,
                    help="work in this dir (kept) instead of a tempdir")
    ap.add_argument("--out", default=os.path.join(REPO, "BACKTEST_TORCH_r17.json"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    defaults = {k: ap.get_default(k)
                for k in ("hours", "rows_per_hour", "heldout_rows", "batch_size")}
    if args.quick:
        args.hours, args.rows_per_hour, args.heldout_rows = 3, 1024, 512
        args.batch_size = 256
    device = resolve_device(args.device)

    # Batch-align every hour: the follow stream only emits full batches, so
    # hour boundaries must land on batch boundaries for the per-hour
    # max_batches bound to be exact.
    args.rows_per_hour -= args.rows_per_hour % args.batch_size
    if args.rows_per_hour <= 0:
        raise SystemExit("--rows-per-hour must hold at least one --batch-size")
    batches_per_hour = args.rows_per_hour // args.batch_size

    run_id = new_run_id()
    tmp_ctx = None
    if args.keep_dir:
        os.makedirs(args.keep_dir, exist_ok=True)
        tmp = args.keep_dir
    else:
        tmp_ctx = tempfile.TemporaryDirectory()
        tmp = tmp_ctx.name
    try:
        stream_path = os.path.join(tmp, "day.fms")
        writer = StreamWriter(stream_path, width=FIELDS, vocabulary_size=VOCAB)
        hour_files = []
        rows = []
        quiet = lambda *_: None  # noqa: E731
        for h in range(args.hours):
            labels, ids, vals = _gen_hour(h, args.hours, args.rows_per_hour, args.seed)
            # The online trainer's stream: append hour h, then follow up to
            # the cumulative batch bound (each hour after the first resumes
            # mid-stream at the cursor).
            writer.append(labels, ids, vals.astype(np.float32))
            hf = os.path.join(tmp, f"hour_{h:02d}.libsvm")
            write_rows(hf, labels, ids, vals, "libsvm")
            hour_files.append(hf)
            te_l, te_i, te_v = _gen_hour(h, args.hours, args.heldout_rows,
                                         args.seed + 1_000_003)
            write_rows(os.path.join(tmp, f"heldout_{h:02d}.libsvm"), te_l, te_i, te_v, "libsvm")

            cfg_on = online_config(tmp, stream_path, (h + 1) * batches_per_hour, args, run_id)
            train(cfg_on, resume=h > 0, log=quiet, device=device)
            cfg_ba = batch_config(tmp, hour_files, args, run_id)
            train(cfg_ba, log=quiet, device=device)

            if h + 1 >= args.hours:
                break
            # Prequential: both models score the NEXT hour before its data
            # arrives.
            nh_l, nh_i, nh_v = _gen_hour(h + 1, args.hours, args.heldout_rows,
                                         args.seed + 1_000_003)
            nxt = os.path.join(tmp, f"heldout_{h + 1:02d}.libsvm")
            write_rows(nxt, nh_l, nh_i, nh_v, "libsvm")
            auc_on = float(_auc_on(cfg_on, nxt, FIELDS, device))
            auc_ba = float(_auc_on(cfg_ba, nxt, FIELDS, device))
            rows.append({
                "hour": h + 1,
                "auc_online": round(auc_on, 5),
                "auc_batch": round(auc_ba, 5),
                "auc_gap": round(auc_ba - auc_on, 5),
            })
            print(f"hour {h + 1:02d}: online {auc_on:.4f}  batch {auc_ba:.4f}  "
                  f"gap {auc_ba - auc_on:+.4f}", flush=True)
        writer.close()

        # kind=quality records ride the ONLINE run's telemetry stream.
        online_jsonl = os.path.join(tmp, "online.jsonl")
        mon = RunMonitor(online_jsonl, run_id=run_id, source="train")
        for r in rows:
            mon.emit("quality", step=r["hour"], **r)
        mon.close()

        # The report gate, as an operator runs it: online against the batch
        # reference's stream, strict.
        report = _report_tool()
        s_on = report.summarize(report.load_run(online_jsonl))
        s_ba = report.summarize(report.load_run(os.path.join(tmp, "batch.jsonl")))
        cmp_text, regressions = report.compare(s_on, s_ba, threshold=args.threshold,
                                               strict=True)
        print(cmp_text)

        worst = max((r["auc_gap"] for r in rows), default=0.0)
        gate_ok = worst <= args.threshold and not any(
            "backtest" in r or "online" in r for r in regressions
        )
        result = {
            **artifact_stamp(run_id),
            "tool": "backtest",
            "hours": args.hours,
            "rows_per_hour": args.rows_per_hour,
            "heldout_rows": args.heldout_rows,
            "batch_size": args.batch_size,
            "vocab": VOCAB,
            "fields": FIELDS,
            "factor_num": K,
            "lr": args.lr,
            "adagrad_decay": args.decay,
            "batch_epochs": args.batch_epochs,
            "drift": "60-degree planted-FM rotation over the day",
            "auc_by_hour": rows,
            "auc_online_mean": round(
                sum(r["auc_online"] for r in rows) / max(1, len(rows)), 5
            ),
            "auc_batch_mean": round(
                sum(r["auc_batch"] for r in rows) / max(1, len(rows)), 5
            ),
            "worst_hour_gap": round(worst, 5),
            "threshold": args.threshold,
            "gate": "OK" if gate_ok else "REGRESSED",
            "report_regressions": regressions,
            **run_stamp(device),
            "reduced": reduced_sizes(args, defaults),
        }
        write_json_artifact(args.out, result, sort_keys=False)
        print(f"wrote {args.out} (gate: {result['gate']})")
        return 0 if gate_ok else 1
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()


if __name__ == "__main__":
    raise SystemExit(main())
