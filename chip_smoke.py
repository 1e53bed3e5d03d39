#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fast_tffm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing one JSON line; any failure exits non-zero before the
last line:

  device    the card's name and, as nvidia-smi reports them, name and power limit
  build     every CUDA kernel of the serving path, built from csrc/ with nvcc
  anova_fwd the ANOVA forward kernel against its plain PyTorch version on the
            card (rtol 1e-5, atol 1e-6) at the serving shapes and inputs,
            with each one's median time per call by CUDA events (ms), its
            device time from a torch.profiler trace (device_ms) and the
            least time the card could take (bound_ms)
  serve     configs/baseline5_fm_order3_kdd.cfg at full width (2^20 x 9
            table from a seed) serving 4096 libsvm lines through serve_lines
            on cuda; every score finite and within atol 1e-6 of the port's
            own CPU path, and the kernel launched on that path
            (then a second pass under torch.profiler: the card's busy and
            idle share of the serving wall time, and its top kernels)
  kernels   one record per kernel: route, source, launches, error and times

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The H100 SXM's published peaks (NVIDIA data sheet) for the bound column.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEED = 20261016
RTOL, ATOL = 1e-5, 1e-6
SERVE_LINES = 4096
NNZ = 11
ANOVA_SHAPES = [(b, NNZ, 8, order) for order in (3, 4) for b in (1, 8, 64, 512, 16384)]
ANOVA_SHAPES.append((130, 7, 5, 3))  # ragged: B off the block edge, k not dividing 32
MAIN_SHAPE = (512, NNZ, 8, 3)  # the full serving bucket of baseline5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def time_ms(fn, reps: int) -> float:
    """Median of per-call times by CUDA events (after a warm-up call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def trace_device(fn):
    """Run ``fn`` once under torch.profiler (CUDA activity, i.e. CUPTI) and
    return its device events as (category, name, microseconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [
        (str(e.get("cat", "")).lower(), e.get("name", ""), float(e["dur"]))
        for e in events
        if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e
    ]


def device_ms(fn, reps: int, name: str | None):
    """Device time per call from a profiler trace of ``reps`` calls: the
    median duration of the kernels whose name contains ``name``, or with
    ``name`` None the summed duration of every kernel per call.  A trace
    sometimes comes back without kernel events; after three such traces
    this gives None (not measured)."""
    fn()

    def many():
        for _ in range(reps):
            fn()

    for _ in range(3):
        durs = [
            d for cat, n, d in trace_device(many)
            if cat == "kernel" and (name is None or name in n)
        ]
        if durs:
            break
    else:
        return None
    if name is None:
        return sum(durs) / reps / 1e3
    durs.sort()
    return durs[len(durs) // 2] / 1e3


def anova_bound(b: int, n: int, k: int, order: int) -> tuple[float, str]:
    """Least time for the work: z read once, out written once; 2 flops per
    fma of the DP plus the degree sums."""
    nbytes = 4 * (b * n * k + b)
    flops = b * k * (2 * order * n + (order - 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build():
    from fast_tffm_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    report = kernel_build.build(["anova_fwd"])
    for name, r in report.items():
        print(f"--- nvcc {name} ---\n{r['log'].strip()}", file=sys.stderr, flush=True)
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "kernels": {k: round(v["seconds"], 3) for k, v in report.items()},
    })


def phase_anova(rng):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_plain

    worst, main = 0.0, None
    for b, n, k, order in ANOVA_SHAPES:
        # z = v·x as the serving path forms it from the serve phase's table:
        # factors v ~ U(±0.25), values x ~ U(0, 1].
        v = rng.uniform(-0.25, 0.25, size=(b, n, k))
        x = 1.0 - rng.random((b, n, 1))
        z = torch.from_numpy((v * x).astype(np.float32)).cuda()
        got = anova_inter(z, order)
        want = anova_inter_plain(z, order)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        abs_err = float(diff.max())
        rel_err = float((diff / want.abs().clamp_min(1e-30)).max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            fail(f"anova_fwd disagrees with its plain version at B={b} N={n} k={k} "
                 f"order={order}: max abs err {abs_err}, max rel err {rel_err}")
        ms = time_ms(lambda: anova_inter(z, order), 200)
        plain_ms = time_ms(lambda: anova_inter_plain(z, order), 50)
        kernel_device_ms = device_ms(lambda: anova_inter(z, order), 50, "anova_fwd_kernel")
        plain_device_ms = device_ms(lambda: anova_inter_plain(z, order), 20, None)
        bound_ms, bound_by = anova_bound(b, n, k, order)
        rec = {
            "phase": "anova_fwd", "B": b, "N": n, "k": k, "order": order,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": ms, "plain_ms": plain_ms,
            "device_ms": kernel_device_ms, "plain_device_ms": plain_device_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(rec)
        worst = max(worst, abs_err)
        if (b, n, k, order) == MAIN_SHAPE:
            main = rec
    return worst, main


def _write_checkpoint(path: str, rng, vocab: int, row_dim: int) -> None:
    """An npz with fast_tffm_tpu/checkpoint.py::_save_npz's members: random
    factors and non-zero biases drawn from the seed."""
    import numpy as np

    table = np.empty((vocab, row_dim), np.float32)
    table[:, 0] = rng.uniform(-0.1, 0.1, vocab)
    table[:, 1:] = rng.uniform(-0.25, 0.25, (vocab, row_dim - 1))
    with open(path, "wb") as f:
        np.savez(
            f,
            table=table,
            table_accum=np.full((vocab, 1), 0.1, np.float32),
            step=np.int64(1),
            save_id=np.frombuffer(b"chip-smoke", np.uint8),
            published_at=np.float64(time.time()),
        )


def _lines(rng, n: int, vocab: int) -> list[str]:
    ids = rng.integers(0, vocab, size=(n, NNZ))
    vals = 1.0 - rng.random((n, NNZ))  # (0, 1]
    labels = rng.integers(0, 2, size=n)
    return [
        f"{labels[i]} " + " ".join(f"{ids[i, j]}:{vals[i, j]:.6f}" for j in range(NNZ))
        for i in range(n)
    ]


def phase_serve(rng, tmp: str):
    import dataclasses

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.ops.anova import anova_inter
    from fast_tffm_tpu_torch.prediction import load_scoring_state, make_score_fn
    from fast_tffm_tpu_torch.serving import serve_lines

    cfg = load_config(os.path.join(HERE, "configs", "baseline5_fm_order3_kdd.cfg"))
    model_file = os.path.join(tmp, "baseline5.ckpt")
    _write_checkpoint(model_file, rng, cfg.vocabulary_size, 1 + cfg.factor_num)
    cfg = dataclasses.replace(cfg, model_file=model_file)
    lines = _lines(rng, SERVE_LINES, cfg.vocabulary_size)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    out = io.StringIO()
    anova_inter.launches = 0
    t0 = time.perf_counter()
    snap = serve_lines(cfg, lines, out=out, log=log, device="cuda")
    serve_s = time.perf_counter() - t0
    launches = anova_inter.launches
    if launches == 0:
        fail("the serving path never launched the anova_fwd kernel")

    printed = np.array([float(s) for s in out.getvalue().split()], np.float64)
    if printed.shape != (SERVE_LINES,) or not np.isfinite(printed).all():
        fail(f"serve_lines returned {printed.shape[0]} scores (finite: "
             f"{bool(np.isfinite(printed).all())}), expected {SERVE_LINES} finite")

    # The port's own CPU path (plain versions) on the same table and lines.
    parsed = parse_lines(lines, vocabulary_size=cfg.vocabulary_size, max_nnz=NNZ)
    batch = Batch(
        labels=torch.from_numpy(parsed.labels),
        ids=torch.from_numpy(parsed.ids.astype(np.int32)),
        vals=torch.from_numpy(parsed.vals),
        fields=torch.zeros((SERVE_LINES, 0), dtype=torch.int32),
        weights=torch.ones(SERVE_LINES),
    )
    quiet = lambda *_: None  # noqa: E731
    model, cpu_state = load_scoring_state(cfg, quiet, device="cpu")
    want = make_score_fn(cfg, cpu_state, NNZ, model=model)(cpu_state, batch).numpy()
    # serve_lines prints %.6f: the printed score must be the CPU score's
    # printed value or its decimal neighbour (a difference within atol).
    printed_cpu = np.array([float(f"{s:.6f}") for s in want], np.float64)
    printed_err = float(np.abs(printed - printed_cpu).max())
    if printed_err > ATOL + 1e-9:
        fail(f"served scores differ from the CPU path by {printed_err} (> {ATOL})")
    # Unrounded: the same rows scored on the card against the CPU path.
    _, gpu_state = load_scoring_state(cfg, quiet, device="cuda")
    got = make_score_fn(cfg, gpu_state, NNZ, model=model)(gpu_state, batch.to("cuda")).cpu().numpy()
    raw_err = float(np.abs(got - want).max())
    if raw_err > ATOL:
        fail(f"card scores differ from the CPU path by {raw_err} (> {ATOL})")

    # A second, traced pass: how much of the wall time the card was busy.
    t0 = time.perf_counter()
    events = trace_device(
        lambda: serve_lines(cfg, lines, out=io.StringIO(), log=quiet, device="cuda")
    )
    traced_s = time.perf_counter() - t0
    busy_ms = sum(d for _, _, d in events) / 1e3
    by_name: dict[str, float] = {}
    for _, name, d in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + d / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])

    total = snap["total_ms"]
    emit({
        "phase": "serve",
        "config": "configs/baseline5_fm_order3_kdd.cfg",
        "vocabulary_size": cfg.vocabulary_size,
        "row_dim": 1 + cfg.factor_num,
        "lines": SERVE_LINES,
        "seconds": serve_s,
        "lines_per_s": SERVE_LINES / serve_s,
        "p50_total_ms": total.get("p50"),
        "p99_total_ms": total.get("p99"),
        "compute_ms": snap["compute_ms"],
        "batch_occupancy": snap["batch_occupancy"],
        "bucket_rows": snap["bucket_rows"],
        "flushes": snap["flushes"],
        "anova_launches": launches,
        "max_abs_err_printed": printed_err,
        "max_abs_err_raw": raw_err,
        "traced_pass": {
            "seconds": traced_s,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (1e3 * traced_s),
            "device_ms_by_kernel": top,
        },
    })
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "fast_tffm_tpu_torch")):
        fail("fast_tffm_tpu_torch/ not found beside chip_smoke.py: run it from a "
             "checkout of the repository", code=2)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    phase_build()
    rng = np.random.default_rng(SEED)
    worst, main = phase_anova(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = phase_serve(rng, tmp)
    emit({"kernels": [{
        "name": "anova_fwd",
        "route": "cuda",
        "source": "fast_tffm_tpu_torch/csrc/anova_fwd.cu",
        "replaces": "fast_tffm_tpu/ops/pallas_anova.py:66",
        "launches": launches,
        "max_abs_err": worst,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the ANOVA sum
    }]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
