#!/usr/bin/env python
"""Beyond-HBM tiered-store probe of the PyTorch/CUDA port: train a
vocabulary past the card's memory on ONE device through the port's
[ParamStore] tiered path, and pin the residency economics — the
counterpart of ``tools/probe_tier.py`` on ``fast_tffm_tpu_torch``, with its
workload, defaults and keys:

  * **hit rate vs coverage curve** — the measured hot-tier hit rate
    (kind=tiering telemetry) next to the EXACT coverage a top-K cache
    should absorb on this workload (host bincount over every gather slot).
    The acceptance bar: measured within a few points of predicted (the
    sample-policy hot set is drawn from a prefix, the curve from the whole
    stream).
  * **gather savings** — the wire/staging bytes the dedup + hit path
    actually shipped, and the CostLedger's record of the step program.

The workload is ``bench_torch.py``'s Zipf(1.1) scale shape (NNZ = 39,
synthesized FMB via ``bench_torch.ensure_scale_fmb``: bench.py's bytes).
It trains in process through ``training.train`` on ``--device`` (the card
unless ``--device cpu``; without a card it raises).  Also reachable as
``python bench_torch.py --tier [args]``.

Keys beyond the JAX tool's: the device stamp (``device``, ``device_name``,
``card``: ``nvidia-smi``'s name and power limit, ``torch_version``,
``cuda_version``), ``device_memory_bytes`` (the card's total memory from
``torch.cuda.mem_get_info``, the host's on the CPU: the wall the resident
state would walk past) and ``kernel_launches`` (the kernel wrappers'
counts over the run).  ``measured_train_step`` keeps its keys; its
``flops`` and ``bytes_accessed`` are null (the port has no compiler cost
analysis) and the note says so.

Usage:
  python tools/torch_probe_tier.py [--vocab 1073741824] [--batch 4096]
      [--steps 12] [--hot 4096] [--device cpu] [--out PROBE_TIER_TORCH_r16.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

# What the port's artifact adds to the JAX tool's keys.
ADDED_KEYS = ("device", "device_name", "card", "torch_version", "cuda_version",
              "device_memory_bytes", "kernel_launches")


def _read_jsonl(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    return [json.loads(l) for l in open(path) if l.strip()]


def coverage_curve(ids: np.ndarray, hot: int) -> tuple[dict, float]:
    """The exact top-K coverage of every gather slot in ``ids``: the curve at
    K = 256, 4096, 65536 and the prediction at ``hot`` (the JAX tool's)."""
    ids = np.asarray(ids).reshape(-1)
    uniq, cnt = np.unique(ids, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    csum = np.cumsum(cnt[order])
    total_slots = ids.size

    def coverage(k: int) -> float:
        k = min(k, csum.size)
        return float(csum[k - 1] / total_slots) if k else 0.0

    return {str(k): round(coverage(k), 4) for k in (256, 4096, 65536)}, coverage(hot)


def device_memory_bytes(device) -> int:
    """The card's total memory, or the host's physical memory on the CPU."""
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.mem_get_info(torch.device(device))[1])
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=1 << 30)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--hot", type=int, default=4096)
    ap.add_argument("--factor-num", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--delta-every", type=int, default=4)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "PROBE_TIER_TORCH_r16.json"))
    args = ap.parse_args(argv)

    from fast_tffm_tpu_torch.telemetry import arm_hang_exit

    watchdog = arm_hang_exit(seconds=3000, what="torch_probe_tier.py")
    try:
        return _probe(args)
    finally:
        watchdog.cancel()


def _probe(args) -> int:
    import bench_torch  # repo-root module: the scale workload's one source of truth
    from fast_tffm_tpu_torch.config import Config
    from fast_tffm_tpu_torch.data.binary import open_fmb
    from fast_tffm_tpu_torch.device import resolve_device
    from fast_tffm_tpu_torch.serving.replica import launch_counts
    from fast_tffm_tpu_torch.telemetry import (
        artifact_stamp,
        device_stamp,
        new_run_id,
        write_json_artifact,
    )
    from fast_tffm_tpu_torch.training import train

    device = resolve_device(args.device)  # the card, or raise
    rows = args.batch * args.steps
    t0 = time.time()
    fmb = bench_torch.ensure_scale_fmb(args.vocab, rows=rows, seed=args.seed)

    # Exact coverage curve over EVERY gather slot of the workload (the
    # prediction the measured hit rate is pinned against).
    curve, predicted = coverage_curve(open_fmb(fmb).ids[:rows], args.hot)

    work = tempfile.mkdtemp(prefix="probe_tier_")
    run_id = new_run_id()
    metrics = os.path.join(work, "metrics.jsonl")
    cfg = Config()
    cfg.model = "fm"
    cfg.factor_num = args.factor_num
    cfg.vocabulary_size = args.vocab
    cfg.hash_feature_id = True  # ensure_scale_fmb writes pre-hashed ids
    cfg.train_files = (fmb,)
    cfg.max_nnz = bench_torch.NNZ
    cfg.epoch_num = 1
    cfg.batch_size = args.batch
    cfg.learning_rate = 0.05
    cfg.log_every = max(1, args.steps // 4)
    cfg.model_file = os.path.join(work, "model.ckpt")
    cfg.metrics_path = metrics
    cfg.telemetry_run_id = run_id
    cfg.save_every_epochs = 1
    cfg.delta_every_steps = args.delta_every
    # Row-granular accumulator: the cold store's accumulator file packs
    # 1024 rows per page instead of one row per ~9-lane stripe.
    cfg.adagrad_accumulator = "row"
    cfg.paramstore = True
    cfg.paramstore_hot_rows = args.hot
    cfg.paramstore_dir = os.path.join(work, "store")
    cfg.paramstore_residency = "sample"
    cfg.paramstore_sample_batches = min(8, args.steps)
    cfg.validate()

    logs: list[str] = []
    launches0 = launch_counts()
    try:
        train(cfg, log=lambda *a: logs.append(" ".join(map(str, a))), device=str(device))
        launches = {k: v - launches0[k] for k, v in launch_counts().items()}
        wall = time.time() - t0
        recs = _read_jsonl(metrics)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    tier = [r for r in recs if r.get("kind") == "tiering"]
    if not tier:
        print("no kind=tiering records emitted — probe failed", file=sys.stderr)
        return 1
    hits = [r["hit_rate"] for r in tier]
    # Weighted by miss exposure windows — simple mean is fine at this
    # probe's uniform window sizes.
    hit_rate = round(sum(hits) / len(hits), 4)
    dedups = [r["dedup_ratio"] for r in tier if r.get("dedup_ratio") is not None]
    miss_bytes = int(np.median([r["miss_bytes_per_step"] for r in tier]))
    wire_bytes = int(np.median([r["wire_bytes_per_step"] for r in tier]))
    steady = sum(
        r.get("compiles", 0)
        for r in recs
        if r.get("kind") == "compile" and not r.get("warmup")
    )
    prof = [
        r
        for r in recs
        if r.get("kind") == "profile" and r.get("program") == "train_step"
    ]
    measured = (
        {
            k: prof[-1].get(k)
            for k in (
                "bytes_accessed", "flops", "examples", "bytes_per_example",
                "modeled_hbm_bytes",
            )
        }
        if prof
        else None
    )

    # The PR-9 committed curve (2^22 scale shape) as the cross-scale
    # reference the JAX tool reports beside its own.
    pr9 = None
    pr9_path = os.path.join(REPO, "PROBE_IDSTATS_r09.json")
    if os.path.exists(pr9_path):
        with open(pr9_path) as f:
            pr9 = json.load(f).get("hot_id_cache_coverage_exact")

    # The resident path at this vocab would need ~vocab*(D+A)*4 bytes of
    # device memory — report the wall it walked past.
    d = args.factor_num + 1
    resident_bytes = args.vocab * (d + 1) * 4
    memory = device_memory_bytes(device)

    out = {
        "probe": "PROBE_TIER",
        **artifact_stamp(run_id),
        **device_stamp(device),
        "workload": {
            "vocab": args.vocab,
            "batch": args.batch,
            "steps": args.steps,
            "nnz": bench_torch.NNZ,
            "row_dim": d,
            "rows": rows,
            "distribution": "zipf_1.1",
            "wall_s": round(wall, 1),
        },
        "hot_rows": args.hot,
        "hit_rate_measured": hit_rate,
        "hit_rate_predicted_exact": round(predicted, 4),
        "hit_rate_gap": round(abs(hit_rate - predicted), 4),
        "coverage_curve_exact": curve,
        "pr9_coverage_curve_2e22": pr9,
        "dedup_ratio_mean": round(sum(dedups) / len(dedups), 4) if dedups else None,
        "miss_bytes_per_step": miss_bytes,
        "wire_bytes_per_step": wire_bytes,
        "resident_state_bytes_this_vocab": resident_bytes,
        "device_memory_bytes": memory,
        "device_tier_rows": args.hot,
        "measured_train_step": measured,
        "steady_state_recompiles": steady,
        "kernel_launches": launches,
        "note": (
            "hit_rate_measured = hot-tier share of gather slots over the "
            "run (kind=tiering); hit_rate_predicted_exact = exact top-"
            f"{args.hot} coverage of this workload's slot distribution — "
            "the sample-policy hot set is drawn from a stream prefix, so a "
            "few points of gap is the expected sampling error.  "
            "resident_state_bytes_this_vocab is what a non-tiered run "
            f"would need on {device.type} (vs its {memory / 1e9:.1f} GB, "
            "device_memory_bytes).  measured_train_step's flops and "
            "bytes_accessed are null: torch has no compiler cost analysis "
            "(modeled_hbm_bytes is the modeled floor)."
        ),
    }
    write_json_artifact(args.out, out)
    print(json.dumps(out, indent=1, sort_keys=True))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
