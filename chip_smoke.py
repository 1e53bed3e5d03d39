#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fast_tffm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing one JSON line; any failure exits non-zero before the
last line:

  device    the card's name and, as nvidia-smi reports them, name and power limit
  build     every CUDA kernel of the ported paths, built from csrc/ with nvcc
            (one nvcc per source, all started together); each kernel
            function's registers, spills and shared memory from -Xptxas=-v
  anova_fwd the ANOVA forward kernel against its plain PyTorch version on the
            card (rtol 1e-5, atol 1e-6) at the serving and training shapes,
            with each one's median time per call by CUDA events (ms), its
            device time from a torch.profiler trace (device_ms) and the
            least time the card could take (bound_ms)
  anova_bwd the ANOVA backward kernel against anova_inter_bwd_plain, the same
            way (rtol 1e-5, atol 1e-6), at B in {1, 512, 16384} x order in
            {3, 4}, a ragged shape and the criteo width N = 39
  data      tools/gen_synthetic.py writes 24 x 16384 baseline5-shaped train
            rows (--seed 7) and 2 x 16384 validation rows (--seed 8)
  rows_tail the rows Adagrad kernel (B4: torch.sort, then one launch on the
            sorted ids) against optim.sparse_adagrad_update on clones of one
            full-width [2^20, 9] state with the first training batch's ids:
            element and row accumulators, decay 1 and 0.9, one id, 1001
            unique ids, and the hot id 0 of a 1000-row batch padded to
            16384; every case bitwise equal.  Times (tail_timings): the
            kernel alone on the sort's output (events; device time L2-warm
            and after a 64 MiB write), the update (sort + kernel), the
            kernel on deduped input, dedup_rows alone, dedup_rows + kernel,
            the hot-id update, the plain twin; bounds for M occurrences and
            for deduped input, and the M-occurrence bound in whole sectors
  fused_tail the fused Adagrad kernel (B3) on a full-width fused state packed
            from a seeded [2^20, 9] table and [2^20, 1] accumulator, against
            its plain version on the card, bitwise, at decay 1 and 0.9 for
            the first batch's ids, one id, 1001 ids, the ids of the last,
            partial tile row (V-4 .. V-1) and the padded batch's hot id 0;
            untouched slots and pad lanes unchanged; unpacked, bitwise
            equal to the rows kernel in row mode on the logical clones; the
            same times as rows_tail
  train     configs/baseline5_fm_order3_kdd.cfg at full width trained for
            24 steps on cuda through training.train (resume from a seeded
            npz; the run traced by torch.profiler), then the same on the CPU:
            finite losses, every kernel of the path launched (the tail once
            per step), the final tables and accumulators within atol 1e-7,
            the updates within 1e-2 by relative norm and moving the same
            elements (to 1e-3), and the validation AUCs within 0.002 of
            each other; the order-3 gradient on the card
            against the CPU's; ex/s, the step time p50, and the card's idle
            share over the run and within one traced step
  train_fused the same run with table_layout = packed and adagrad_accumulator
            = fused (a [V, 1] accumulator in the npz): the fused kernel once
            per step, the card's unpacked table and accumulator within atol
            1e-7 of the CPU run's, the same update and AUC checks and timings
  predict   prediction.predict of the trained model on the validation file
            on cuda, its printed scores within 1e-6 of the CPU predict's
  predict_packed the same for the fused run's checkpoint under its packed
            config (scored through the packed gather)
  serve     the same config serving 4096 libsvm lines through serve_lines
            on cuda from a seeded 2^20 x 9 table; every score finite and
            within atol 1e-6 of the port's own CPU path, and the forward
            kernel launched on that path (then a second pass under
            torch.profiler: the card's busy and idle share of the serving
            wall time, and its top kernels); then the same lines served on
            cuda under table_layout = packed, within atol 1e-6 of the rows
            config's scores
  kernels   one record per kernel: route, source, launches on the training
            path (the fused kernel's on the fused one), error and times at
            the training shapes

The last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import io
import json
import os
import re
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
KERNELS = ["anova_fwd", "anova_bwd", "rows_tail_adagrad", "fused_tail_adagrad"]
ANOVA_SHAPES = [(b, NNZ, 8, order) for order in (3, 4) for b in (1, 8, 64, 512, 16384)]
ANOVA_SHAPES.append((130, 7, 5, 3))  # ragged: B off the block edge, k not dividing 32
BWD_SHAPES = [(b, NNZ, 8, order) for order in (3, 4) for b in (1, 512, 16384)]
BWD_SHAPES += [(130, 7, 5, 3), (2048, 39, 8, 3)]  # ragged; criteo's 39 features
TRAIN_SHAPE = (16384, NNZ, 8, 3)  # baseline5's training batch
BATCH = 16384  # baseline5's batch_size
TRAIN_BATCHES, VALID_BATCHES = 24, 2
# The card's trained table and accumulators against the CPU run's.  24 steps
# move a factor element by ~1e-7 or less, so 1e-5 would pass a run that
# dropped them: the atol sits near the float32 spacing of the table's values
# (~1e-9 at 0.01, ~7e-9 at the accumulators' 0.1), and the updates
# themselves (final minus initial table) are held per column group, by
# relative norm and by the count of elements they moved.
TABLE_ATOL, AUC_TOL = 1e-7, 0.002
UPDATE_RTOL, MOVED_RTOL = 1e-2, 1e-3
CONFIG = os.path.join("configs", "baseline5_fm_order3_kdd.cfg")
# baseline5 on the fused lane-packed layout: no shipped config sets these.
FUSED = {"table_layout": "packed", "adagrad_accumulator": "fused"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def log_stderr(*a):
    print(*a, file=sys.stderr, flush=True)


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


def traced_window(fn) -> dict:
    """``fn`` under the profiler, its wall time taken inside the traced
    region (so the profiler's own start and export are not counted): the
    card's busy time, idle share of that wall time and top kernels.  A
    trace without device events gives None for busy and idle (not
    measured)."""
    import torch

    wall = []

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    events = trace_device(timed)
    by_name: dict[str, float] = {}
    for _, name, dur in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + dur / 1e3
    busy_ms = sum(dur for _, _, dur in events) / 1e3 if events else None
    return {
        "wall_ms": 1e3 * wall[0],
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / (1e3 * wall[0]),
        "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
    }


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


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms: bytes over the memory rate or float32
    operations over the peak rate, whichever is larger, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def anova_bound(b: int, n: int, k: int, order: int) -> tuple[float, str]:
    """Forward: z read once, out written once; 2 flops per fma of the DP
    plus the degree sums."""
    return _bound(4 * (b * n * k + b), b * k * (2 * order * n + (order - 1)))


def bwd_bound(b: int, n: int, k: int, order: int) -> tuple[float, str]:
    """Backward: z and g read once, zbar written once; per (example,
    factor) the forward recompute (N·order fma) and the reverse DP
    (2·N·(order−1) fma), 2 flops each."""
    return _bound(4 * (2 * b * n * k + b), 2 * b * k * n * (3 * order - 2))


def tail_bound(m: int, k: int, d: int, a: int) -> tuple[float, str]:
    """The tail kernels' work: M sorted occurrences onto K unique rows.
    Per occurrence the sorted id (4 B), the sort's int64 index and the
    gradient row read once, one add per gradient element; per unique row
    the table row and its A accumulator floats (a fused slot: A = 1) read
    and written once, ~6 flops a table element (g², add, lr·g, sqrt,
    divide, subtract).  On deduped input M = K."""
    return _bound(m * (4 + 8 + 4 * d) + k * 8 * (d + a), m * d + 6 * k * d)


def tail_sector_bound(m: int, k: int, d: int, a: int, fused: bool) -> float:
    """``tail_bound``'s bytes counted in the 32-byte sectors the card moves:
    a random row of b bytes at an a-byte aligned offset spans (b - a)/32 + 1
    sectors on average (a 36-byte table row 2, a 4-byte row accumulator 1,
    a 40-byte fused slot 2).  The sorted ids and indices stream whole.
    Returns ms at the memory rate."""
    spans = lambda b, align: (b - align) / 32 + 1  # noqa: E731
    row = 2 * 32 * (spans(4 * (d + 1), 8) if fused else spans(4 * d, 4) + spans(4 * a, 4))
    return 1e3 * (m * (12 + 32 * spans(4 * d, 4)) + k * row) / HBM_BYTES_PER_S


def flushed(fn):
    """``fn`` after writing a 64 MiB buffer, more than the H100's 50 MB L2,
    so ``fn`` finds none of its operands in the cache."""
    import torch

    buf = torch.empty(16 << 20, device="cuda")

    def run():
        buf.fill_(1.0)
        fn()

    return run


def _padded_batch(ids, grads, real: int = 1000):
    """The first ``real`` rows of a batch, padded back to its size as
    data/libsvm.pad_batch pads a short last batch: every pad slot id 0,
    with the zero gradient a weight-0 row gets."""
    hot_ids, hot_grads = ids.clone(), grads.clone()
    hot_ids[real:] = 0
    hot_grads[real:] = 0.0
    return hot_ids, hot_grads


def _tail_timings(kern: str, kernel, update, apply, dedup, dedup_apply, hot, plain) -> dict:
    """The tail timings of one call: the kernel alone on the sort's output
    (events; device time by name, L2-warm and after a 64 MiB write), the
    update (sort + kernel), the kernel on deduped input, the dedup alone,
    the dedup + kernel on its output (a separate dedup pass), the hot-id update
    and the plain twin on the sort's output."""
    return {
        "ms": time_ms(kernel, 100),
        "device_ms": device_ms(kernel, 30, kern),
        "device_ms_flushed": device_ms(flushed(kernel), 30, kern),
        "update_ms": time_ms(update, 100),
        "update_device_ms": device_ms(update, 30, None),
        "apply_ms": time_ms(apply, 100),
        "apply_device_ms": device_ms(apply, 30, kern),
        "dedup_ms": time_ms(dedup, 30),
        "dedup_device_ms": device_ms(dedup, 10, None),
        "dedup_apply_ms": time_ms(dedup_apply, 30),
        "dedup_apply_device_ms": device_ms(dedup_apply, 10, None),
        "hot_update_ms": time_ms(hot, 10),
        "hot_update_device_ms": device_ms(hot, 5, None),
        "hot_device_ms": device_ms(hot, 5, kern),
        "plain_ms": time_ms(plain, 30),
        "plain_device_ms": device_ms(plain, 10, None),
    }


def _check_close(name: str, got, want, rtol: float, atol: float, where: str) -> tuple[float, float]:
    """Max abs and rel error of ``got`` against ``want``; fails outside the
    tolerance."""
    import torch

    diff = (got - want).abs()
    abs_err = float(diff.max()) if diff.numel() else 0.0
    rel_err = float((diff / want.abs().clamp_min(1e-30)).max()) if diff.numel() else 0.0
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name} disagrees with its plain version at {where}: max abs err "
             f"{abs_err}, max rel err {rel_err} (rtol {rtol}, atol {atol})")
    return abs_err, rel_err


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


def _ptxas_report(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    function in nvcc's ``-Xptxas=-v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            out[name].update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    return out


def phase_build():
    from fast_tffm_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    report = kernel_build.build(KERNELS)
    for name, r in report.items():
        log_stderr(f"--- nvcc {name} ---\n{r['log'].strip()}")
    emit({
        "phase": "build",
        "seconds": round(time.perf_counter() - t0, 3),
        "kernels": {k: round(v["seconds"], 3) for k, v in report.items()},
        "ptxas": {k: _ptxas_report(v["log"]) for k, v in report.items()},
    })


def _z(rng, b: int, n: int, k: int):
    """z = v·x as the serving and training paths form it: factors
    v ~ U(±0.25), values x ~ U(0, 1]."""
    import numpy as np
    import torch

    v = rng.uniform(-0.25, 0.25, size=(b, n, k))
    x = 1.0 - rng.random((b, n, 1))
    return torch.from_numpy((v * x).astype(np.float32)).cuda()


def phase_anova(rng):
    import torch

    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_plain

    worst, main = 0.0, None
    for b, n, k, order in ANOVA_SHAPES:
        z = _z(rng, b, n, k)
        got = anova_inter(z, order)
        want = anova_inter_plain(z, order)
        torch.cuda.synchronize()
        abs_err, rel_err = _check_close(
            "anova_fwd", got, want, RTOL, ATOL, f"B={b} N={n} k={k} order={order}"
        )
        bound_ms, bound_by = anova_bound(b, n, k, order)
        rec = {
            "phase": "anova_fwd", "B": b, "N": n, "k": k, "order": order,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: anova_inter(z, order), 200),
            "plain_ms": time_ms(lambda: anova_inter_plain(z, order), 50),
            "device_ms": device_ms(lambda: anova_inter(z, order), 50, "anova_fwd_kernel"),
            "plain_device_ms": device_ms(lambda: anova_inter_plain(z, order), 20, None),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(rec)
        worst = max(worst, abs_err)
        if (b, n, k, order) == TRAIN_SHAPE:
            main = rec
    return worst, main


def phase_anova_bwd(rng):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.anova import anova_inter_bwd, anova_inter_bwd_plain

    worst, main = 0.0, None
    for b, n, k, order in BWD_SHAPES:
        z = _z(rng, b, n, k)
        g = torch.from_numpy(rng.uniform(-1.0, 1.0, size=b).astype(np.float32)).cuda()
        got = anova_inter_bwd(z, g, order)
        want = anova_inter_bwd_plain(z, g, order)
        torch.cuda.synchronize()
        abs_err, rel_err = _check_close(
            "anova_bwd", got, want, RTOL, ATOL, f"B={b} N={n} k={k} order={order}"
        )
        bound_ms, bound_by = bwd_bound(b, n, k, order)
        rec = {
            "phase": "anova_bwd", "B": b, "N": n, "k": k, "order": order,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "ms": time_ms(lambda: anova_inter_bwd(z, g, order), 100),
            "plain_ms": time_ms(lambda: anova_inter_bwd_plain(z, g, order), 20),
            "device_ms": device_ms(lambda: anova_inter_bwd(z, g, order), 30, "anova_bwd_kernel"),
            "plain_device_ms": device_ms(lambda: anova_inter_bwd_plain(z, g, order), 5, None),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit(rec)
        worst = max(worst, abs_err)
        if (b, n, k, order) == TRAIN_SHAPE:
            main = rec
    return worst, main


def phase_data(tmp: str) -> tuple[str, str]:
    """baseline5-shaped libsvm files from tools/gen_synthetic.py (numpy
    only), both generators at once."""
    t0 = time.perf_counter()
    gen = os.path.join(HERE, "tools", "gen_synthetic.py")
    out, procs = {}, []
    for name, batches, seed in (("train", TRAIN_BATCHES, 7), ("valid", VALID_BATCHES, 8)):
        out[name] = os.path.join(tmp, f"baseline5.{name}.libsvm")
        cmd = [sys.executable, gen, "--rows", str(batches * BATCH), "--fields", str(NNZ),
               "--vocab", str(1 << 20), "--seed", str(seed), "--out", out[name]]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                             stderr=subprocess.PIPE, text=True)))
    for name, proc in procs:
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
                p.wait()
            fail(f"gen_synthetic ({name}) did not finish in 300 s")
        if proc.returncode != 0:
            fail(f"gen_synthetic ({name}) failed with exit {proc.returncode}: {err}")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "train_rows": TRAIN_BATCHES * BATCH, "valid_rows": VALID_BATCHES * BATCH})
    return out["train"], out["valid"]


def _first_batch_ids(path: str, vocab: int):
    import itertools

    import numpy as np

    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    with open(path) as f:
        lines = list(itertools.islice(f, BATCH))
    return parse_lines(lines, vocabulary_size=vocab, max_nnz=NNZ).ids.astype(np.int32)


def phase_rows_tail(rng, train_path: str):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.tail import (
        rows_tail_adagrad_update,
        rows_tail_apply,
        rows_tail_sorted,
        rows_tail_sorted_plain,
    )
    from fast_tffm_tpu_torch.optim import dedup_rows, sparse_adagrad_update

    vocab, d, lr = 1 << 20, 1 + 8, 0.05
    ids = torch.from_numpy(_first_batch_ids(train_path, vocab)).cuda()
    grads = torch.from_numpy(
        (rng.normal(size=(BATCH, NNZ, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    accums = {
        "element": torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, d)).astype(np.float32)).cuda(),
        "row": torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, 1)).astype(np.float32)).cuda(),
    }
    sets = {
        "batch": (ids, grads),
        "one id": (ids[:1, :1], grads[:1, :1]),
        "1001 ids": (torch.unique(ids)[:1001].to(torch.int32),  # K = 1001 = 7·11·13
                     grads.reshape(-1, d)[:1001]),
        "hot id 0": _padded_batch(ids, grads),
    }
    cases = [
        ("element", 1.0, "batch"), ("element", 0.9, "batch"),
        ("row", 1.0, "batch"), ("row", 0.9, "batch"),
        ("element", 1.0, "one id"), ("row", 1.0, "one id"),
        ("element", 1.0, "1001 ids"), ("row", 0.9, "1001 ids"),
        ("element", 1.0, "hot id 0"), ("row", 0.9, "hot id 0"),
    ]
    main = None
    for acc, decay, which in cases:
        c_ids, c_grads = sets[which]
        t_k, a_k = table.clone(), accums[acc].clone()
        t_p, a_p = table.clone(), accums[acc].clone()
        rows_tail_adagrad_update(t_k, a_k, c_ids, c_grads, lr, decay=decay)
        sparse_adagrad_update(t_p, a_p, c_ids, c_grads, lr, decay=decay)
        torch.cuda.synchronize()
        k = int(torch.unique(c_ids).numel())
        where = f"{acc} accumulator, decay {decay}, {which} (K={k})"
        if not (torch.equal(t_k, t_p) and torch.equal(a_k, a_p)):
            err = float(max((t_k - t_p).abs().max(), (a_k - a_p).abs().max()))
            fail(f"rows_tail is not bitwise equal to its plain version: {where}, max abs err {err}")
        rec = {"phase": "rows_tail", "accumulator": acc, "decay": decay, "ids": which,
               "M": int(c_ids.numel()), "K": k, "bitwise": True, "max_abs_err": 0.0}
        if which == "batch" and decay == 1.0:
            flat_ids, flat_g = c_ids.reshape(-1), c_grads.reshape(-1, d)
            uids, gsum = dedup_rows(flat_ids, flat_g)
            sid, order = torch.sort(flat_ids, stable=True)
            hot_ids, hot_grads = sets["hot id 0"]
            m, a = flat_ids.numel(), a_k.shape[1]
            rec.update(_tail_timings(
                f"rows_{acc}_kernel",
                kernel=lambda: rows_tail_sorted(t_k, a_k, sid, order, flat_g, lr),
                update=lambda: rows_tail_adagrad_update(t_k, a_k, c_ids, c_grads, lr),
                apply=lambda: rows_tail_apply(t_k, a_k, uids, gsum, lr),
                dedup=lambda: dedup_rows(flat_ids, flat_g),
                dedup_apply=lambda: rows_tail_apply(t_k, a_k, *dedup_rows(flat_ids, flat_g), lr),
                hot=lambda: rows_tail_adagrad_update(t_k, a_k, hot_ids, hot_grads, lr),
                plain=lambda: rows_tail_sorted_plain(t_p, a_p, sid, order, flat_g, lr),
            ))
            rec["bound_ms"], rec["bound_by"] = tail_bound(m, k, d, a)
            rec["sector_bound_ms"] = tail_sector_bound(m, k, d, a, fused=False)
            rec["apply_bound_ms"] = tail_bound(k, k, d, a)[0]
            rec["hot_K"] = int(torch.unique(hot_ids).numel())
            if acc == "element":
                main = rec
        emit(rec)
    return 0.0, main


def _blank_touched(fused, ids, d: int):
    """``fused`` with the slots of ``ids`` zeroed: what an update of ``ids``
    must leave bitwise unchanged (other slots, pad slots, tail lanes)."""
    from fast_tffm_tpu_torch.ops.packed_table import fused_rows_per_tile, fused_slots

    out = fused.clone()
    p = fused_rows_per_tile(d)
    i = ids.reshape(-1).long().unique()
    fused_slots(out, d)[i // p, i % p] = 0.0
    return out


def phase_fused_tail(rng, train_path: str):
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops.packed_table import pack_fused, unpack_fused
    from fast_tffm_tpu_torch.ops.tail import (
        fused_adagrad_plain,
        fused_tail_adagrad_update,
        fused_tail_apply,
        fused_tail_sorted,
        fused_tail_sorted_plain,
        rows_tail_adagrad_update,
    )
    from fast_tffm_tpu_torch.optim import dedup_rows

    vocab, d, lr = 1 << 20, 1 + 8, 0.05
    ids = torch.from_numpy(_first_batch_ids(train_path, vocab)).cuda()
    grads = torch.from_numpy(
        (rng.normal(size=(BATCH, NNZ, d)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, size=(vocab, d)).astype(np.float32)).cuda()
    accum = torch.from_numpy(rng.uniform(0.1, 0.5, size=(vocab, 1)).astype(np.float32)).cuda()
    fused = pack_fused(table, accum, 0.1)  # 2^20 mod 12 = 4: a partial last tile row
    flat_g = grads.reshape(-1, d)
    sets = {
        "batch": (ids, grads),
        "one id": (ids[:1, :1], grads[:1, :1]),
        "1001 ids": (torch.unique(ids)[:1001].to(torch.int32), flat_g[:1001]),
        "last tile row": (torch.arange(vocab - 4, vocab, dtype=torch.int32, device="cuda"),
                          flat_g[:4]),
        "hot id 0": _padded_batch(ids, grads),
    }
    main = None
    for decay in (1.0, 0.9):
        for which, (c_ids, c_grads) in sets.items():
            got = fused_tail_adagrad_update(fused.clone(), c_ids, c_grads, lr, decay=decay)
            uids, gsum = dedup_rows(c_ids.reshape(-1), c_grads.reshape(-1, d))
            twin = fused_adagrad_plain(fused.clone(), uids, gsum, lr, decay)
            t_r, a_r = table.clone(), accum.clone()
            rows_tail_adagrad_update(t_r, a_r, c_ids, c_grads, lr, decay=decay)
            torch.cuda.synchronize()
            k = int(uids.numel())
            where = f"decay {decay}, {which} (K={k})"
            if not torch.equal(got, twin):
                err = float((got - twin).abs().max())
                fail(f"fused_tail is not bitwise equal to its plain version: {where}, "
                     f"max abs err {err}")
            t_f, a_f = unpack_fused(got, vocab, d)
            if not (torch.equal(t_f, t_r) and torch.equal(a_f, a_r)):
                fail(f"fused_tail unpacked differs from the rows kernel in row mode: {where}")
            if not torch.equal(_blank_touched(got, c_ids, d), _blank_touched(fused, c_ids, d)):
                fail(f"fused_tail changed lanes outside the touched slots: {where}")
            if torch.equal(got, fused):
                fail(f"fused_tail changed nothing: {where}")
            rec = {"phase": "fused_tail", "decay": decay, "ids": which,
                   "M": int(c_ids.numel()), "K": k,
                   "bitwise": True, "bitwise_rows_row": True, "max_abs_err": 0.0}
            if which == "batch" and decay == 1.0:
                flat_ids = c_ids.reshape(-1)
                sid, order = torch.sort(flat_ids, stable=True)
                hot_ids, hot_grads = sets["hot id 0"]
                rec.update(_tail_timings(
                    "fused_slot_kernel",
                    kernel=lambda: fused_tail_sorted(got, sid, order, flat_g, lr),
                    update=lambda: fused_tail_adagrad_update(got, c_ids, c_grads, lr),
                    apply=lambda: fused_tail_apply(got, uids, gsum, lr),
                    dedup=lambda: dedup_rows(flat_ids, flat_g),
                    dedup_apply=lambda: fused_tail_apply(got, *dedup_rows(flat_ids, flat_g), lr),
                    hot=lambda: fused_tail_adagrad_update(got, hot_ids, hot_grads, lr),
                    plain=lambda: fused_tail_sorted_plain(twin, sid, order, flat_g, lr),
                ))
                rec["bound_ms"], rec["bound_by"] = tail_bound(flat_ids.numel(), k, d, 1)
                rec["sector_bound_ms"] = tail_sector_bound(flat_ids.numel(), k, d, 1, fused=True)
                rec["apply_bound_ms"] = tail_bound(k, k, d, 1)[0]
                rec["hot_K"] = int(torch.unique(hot_ids).numel())
                main = rec
            emit(rec)
    return 0.0, main


def _write_checkpoint(path: str, table, accum_width: int) -> None:
    """An npz with fast_tffm_tpu/checkpoint.py::_save_npz's members at step
    0: ``table`` and Adagrad accumulators of ``accum_width`` at 0.1."""
    import numpy as np

    with open(path, "wb") as f:
        np.savez(
            f,
            table=table,
            table_accum=np.full((table.shape[0], accum_width), 0.1, np.float32),
            step=np.int32(0),
            save_id=np.frombuffer(os.path.basename(path).encode(), np.uint8),
            published_at=np.float64(time.time()),
        )


def _train_once(cfg, device: str, log_to: list):
    from fast_tffm_tpu_torch.training import train

    def log(*a):
        msg = " ".join(str(x) for x in a)
        log_to.append(msg)
        log_stderr(f"[train {device}] {msg}")

    t0 = time.perf_counter()
    state = train(cfg, resume=True, log=log, device=device)
    return state, time.perf_counter() - t0


def _logged(lines: list, what: str) -> list[float]:
    """The number after ``what`` in every log line that carries it."""
    out = []
    for line in lines:
        toks = line.split()
        for i, t in enumerate(toks[:-1]):
            if t == what:
                out.append(float(toks[i + 1].replace(",", "")))
    return out


def _update_check(init, card, cpu) -> dict:
    """The run's updates (final table minus ``init``) on the card against
    the CPU's, for the bias column and the factor columns apart: the
    relative norm of their difference within UPDATE_RTOL, and the count of
    elements they moved within MOVED_RTOL of the CPU's (a path that drops
    the small updates of ordinary rows moves far fewer)."""
    import numpy as np

    out = {}
    for name, cols in (("bias", slice(0, 1)), ("factors", slice(1, None))):
        d_card = card[:, cols].astype(np.float64) - init[:, cols]
        d_cpu = cpu[:, cols].astype(np.float64) - init[:, cols]
        moved = {"cuda": int(np.count_nonzero(d_card)), "cpu": int(np.count_nonzero(d_cpu))}
        norm = float(np.linalg.norm(d_cpu))
        rel = float(np.linalg.norm(d_card - d_cpu)) / norm if norm else float("inf")
        out[name] = {"rel_norm_diff": rel, "moved": moved, "max_abs_update": float(np.abs(d_cpu).max())}
        if not (moved["cpu"] and rel <= UPDATE_RTOL
                and abs(moved["cuda"] - moved["cpu"]) <= MOVED_RTOL * moved["cpu"]):
            fail(f"the card's {name} updates differ from the CPU run's: {out[name]}")
    return out


def _gradient_check(model, table, batch) -> dict:
    """The order-3 gradient of the training loss with respect to the
    gathered rows, on the card (forward and backward kernels) and on the
    CPU (their plain versions), from one table: within 1e-5 of the largest
    gradient, and non-zero in the factor columns."""
    import torch

    from fast_tffm_tpu_torch.trainer import batch_loss

    grads = []
    for dev in ("cuda", "cpu"):
        b = batch.to(dev)
        rows = table.to(dev)[b.ids].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(batch_loss(model, rows, [], b)[0], rows)
        grads.append(g.cpu())
    scale = float(grads[1].abs().max())
    err = float((grads[0] - grads[1]).abs().max())
    factor_max = float(grads[0][..., 1:].abs().max())
    if not err <= RTOL * scale or factor_max == 0.0:
        fail(f"order-3 gradient on the card differs from the CPU's: max abs err {err} "
             f"against a largest gradient of {scale}; factor columns max {factor_max}")
    return {"max_abs_err": err, "max_abs_grad": scale, "factor_max_abs_grad": factor_max}


def phase_train(rng, tmp: str, train_path: str, valid_path: str, fused: bool = False):
    """The rows run (``fused`` False) or the fused lane-packed run of
    baseline5, on the card and then on the CPU from one seeded npz."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.models.base import Batch
    from fast_tffm_tpu_torch.ops.anova import anova_inter, anova_inter_bwd
    from fast_tffm_tpu_torch.ops.tail import fused_tail_adagrad_update, rows_tail_adagrad_update
    from fast_tffm_tpu_torch.trainer import make_packed_train_step, make_train_step, unpack_state

    name = "train_fused" if fused else "train"
    base = load_config(os.path.join(HERE, CONFIG))
    if fused:
        base = dataclasses.replace(base, **FUSED).validate()
    model = build_model(base)
    # The initial state: factors U(±0.01) from the seed, zero bias, element
    # accumulators (rows) or a [V, 1] row accumulator (fused).
    table = np.zeros((base.vocabulary_size, model.row_dim), np.float32)
    table[:, 1:] = rng.uniform(-0.01, 0.01, (base.vocabulary_size, model.row_dim - 1))
    init = os.path.join(tmp, f"{name}.init.ckpt")
    _write_checkpoint(init, table, 1 if fused else model.row_dim)

    def cfg_for(device):
        model_file = os.path.join(tmp, f"{name}.{device}.ckpt")
        shutil.copy(init, model_file)
        return dataclasses.replace(
            base, train_files=(train_path,), validation_files=(valid_path,),
            predict_files=(valid_path,), model_file=model_file,
            score_path=os.path.join(tmp, f"{name}.{device}.scores"), log_every=4,
        )

    # The main path: train on the card, under the profiler for its idle share.
    cuda_cfg, cuda_log, result = cfg_for("cuda"), [], {}
    tail_kernel, tail_name = (
        (fused_tail_adagrad_update, "fused_tail") if fused else (rows_tail_adagrad_update, "rows_tail")
    )
    anova_inter.launches = anova_inter_bwd.launches = 0
    rows_tail_adagrad_update.launches = fused_tail_adagrad_update.launches = 0
    run = traced_window(lambda: result.update(state=_train_once(cuda_cfg, "cuda", cuda_log)[0]))
    launches = {
        "anova_fwd": anova_inter.launches,
        "anova_bwd": anova_inter_bwd.launches,
        tail_name: tail_kernel.launches,
    }
    other_tail = rows_tail_adagrad_update.launches if fused else fused_tail_adagrad_update.launches
    cuda_state, cuda_s = unpack_state(result["state"], model), run["wall_ms"] / 1e3
    if launches["anova_fwd"] == 0 or launches["anova_bwd"] == 0:
        fail(f"the {name} path did not launch both ANOVA kernels: {launches}")
    if launches[tail_name] != TRAIN_BATCHES or other_tail:
        fail(f"the {tail_name} kernel ran {launches[tail_name]} times for "
             f"{TRAIN_BATCHES} steps (the other tail {other_tail} times)")
    losses = _logged(cuda_log, "loss")
    if not losses or not all(np.isfinite(losses)):
        fail(f"non-finite or missing training losses on the card: {losses}")

    cpu_cfg, cpu_log = cfg_for("cpu"), []
    cpu_state, cpu_s = _train_once(cpu_cfg, "cpu", cpu_log)
    cpu_state = unpack_state(cpu_state, model)
    table_err = float((cuda_state.table.cpu() - cpu_state.table).abs().max())
    accum_err = float((cuda_state.table_accum.cpu() - cpu_state.table_accum).abs().max())
    if not (table_err <= TABLE_ATOL and accum_err <= TABLE_ATOL):
        fail(f"the card's trained table and accumulators differ from the CPU run's by "
             f"{table_err} and {accum_err}")
    updates = _update_check(table, cuda_state.table.cpu().numpy(), cpu_state.table.numpy())
    auc_cuda, auc_cpu = _logged(cuda_log, "auc"), _logged(cpu_log, "auc")
    if not (auc_cuda and auc_cpu and abs(auc_cuda[-1] - auc_cpu[-1]) <= AUC_TOL
            and auc_cuda[-1] > 0.5):
        fail(f"validation AUC on the card {auc_cuda} against the CPU's {auc_cpu}")

    parsed, w = next(batch_stream([valid_path], batch_size=BATCH,
                                  vocabulary_size=base.vocabulary_size, max_nnz=NNZ))
    host_batch = Batch.from_parsed(parsed, w)
    # The repaired gradient, on a validation batch, from the CPU run's table.
    grad = None if fused else _gradient_check(model, cpu_state.table, host_batch)

    # Step time on the card with the input already there; then one traced step.
    if fused:
        step, cuda_state = make_packed_train_step(model, base.learning_rate), result["state"]
    else:
        step = make_train_step(model, base.learning_rate)
    batch = host_batch.to("cuda")
    times = []
    for _ in range(12):
        t0 = time.perf_counter()
        cuda_state, _ = step(cuda_state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[2:])
    emit({
        "phase": name,
        "config": CONFIG + (" + " + json.dumps(FUSED) if fused else ""),
        "steps": TRAIN_BATCHES,
        "batch_size": BATCH,
        "launches": launches,
        "losses": losses,
        "examples_per_s_logged": _logged(cuda_log, "examples/sec"),
        "examples_per_s_run": TRAIN_BATCHES * BATCH / cuda_s,
        "seconds": {"cuda": cuda_s, "cpu": cpu_s},
        "step_ms_p50": times[len(times) // 2],
        "step_ms_min": times[0],
        "step_examples_per_s": BATCH / (times[len(times) // 2] / 1e3),
        "validation_auc": {"cuda": auc_cuda[-1], "cpu": auc_cpu[-1]},
        "max_abs_table_diff": table_err,
        "max_abs_accum_diff": accum_err,
        "updates": updates,
        "gradient": grad,
        "traced_run": run,
        "traced_step": traced_window(lambda: step(cuda_state, batch)),
    })
    return cuda_cfg, launches


def phase_predict(cuda_cfg, name: str = "predict"):
    import dataclasses

    import numpy as np

    from fast_tffm_tpu_torch.ops.anova import anova_inter
    from fast_tffm_tpu_torch.prediction import predict

    paths, seconds = {}, {}
    for device in ("cuda", "cpu"):
        cfg = dataclasses.replace(cuda_cfg, score_path=f"{cuda_cfg.score_path}.{device}")
        anova_inter.launches = 0
        t0 = time.perf_counter()
        predict(cfg, log=log_stderr, device=device)
        seconds[device] = time.perf_counter() - t0
        if device == "cuda" and anova_inter.launches == 0:
            fail(f"{name} on cuda never launched the anova_fwd kernel")
        paths[device] = cfg.score_path
    got, want = np.loadtxt(paths["cuda"]), np.loadtxt(paths["cpu"])
    if got.shape != (VALID_BATCHES * BATCH,) or not np.isfinite(got).all():
        fail(f"predict wrote {got.shape} scores, expected {VALID_BATCHES * BATCH} finite")
    err = float(np.abs(got - want).max())
    # %.6f scores: the card's and the CPU's printed values may differ by one
    # decimal step where the unrounded scores straddle a rounding boundary.
    if err > ATOL + 1e-9:
        fail(f"predict scores on the card differ from the CPU's by {err}")
    emit({"phase": name, "table_layout": cuda_cfg.table_layout, "scores": int(got.shape[0]),
          "max_abs_err_printed": err, "seconds": seconds})


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

    cfg = load_config(os.path.join(HERE, CONFIG))
    # Random factors and non-zero biases from the seed.
    table = np.empty((cfg.vocabulary_size, 1 + cfg.factor_num), np.float32)
    table[:, 0] = rng.uniform(-0.1, 0.1, cfg.vocabulary_size)
    table[:, 1:] = rng.uniform(-0.25, 0.25, (cfg.vocabulary_size, cfg.factor_num))
    model_file = os.path.join(tmp, "baseline5.serve.ckpt")
    _write_checkpoint(model_file, table, 1)
    cfg = dataclasses.replace(cfg, model_file=model_file)
    lines = _lines(rng, SERVE_LINES, cfg.vocabulary_size)

    out = io.StringIO()
    anova_inter.launches = 0
    t0 = time.perf_counter()
    snap = serve_lines(cfg, lines, out=out, log=log_stderr, device="cuda")
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
    batch = Batch.from_parsed(parsed)
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
    torch.cuda.synchronize()

    # The same table and lines served under table_layout = packed.
    packed_cfg = dataclasses.replace(cfg, **FUSED).validate()
    packed_out = io.StringIO()
    anova_inter.launches = 0
    t0 = time.perf_counter()
    serve_lines(packed_cfg, lines, out=packed_out, log=log_stderr, device="cuda")
    packed_s = time.perf_counter() - t0
    packed_printed = np.array([float(s) for s in packed_out.getvalue().split()], np.float64)
    if packed_printed.shape != (SERVE_LINES,) or anova_inter.launches == 0:
        fail(f"packed serving returned {packed_printed.shape[0]} scores with "
             f"{anova_inter.launches} anova_fwd launches")
    packed_err = float(np.abs(packed_printed - printed).max())
    if packed_err > ATOL + 1e-9:
        fail(f"packed serving differs from the rows config's scores by {packed_err}")
    _, packed_state = load_scoring_state(packed_cfg, quiet, device="cuda")
    got = make_score_fn(packed_cfg, packed_state, NNZ, model=model)(
        packed_state, batch.to("cuda")).cpu().numpy()
    packed_raw_err = float(np.abs(got - want).max())
    if packed_state.layout != "packed" or packed_raw_err > ATOL:
        fail(f"packed card scores differ from the CPU path by {packed_raw_err} "
             f"(layout {packed_state.layout})")

    total = snap["total_ms"]
    emit({
        "phase": "serve",
        "config": CONFIG,
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
        "packed": {"table_layout": "packed", "seconds": packed_s,
                   "max_abs_err_printed_vs_rows": packed_err,
                   "max_abs_err_raw": packed_raw_err},
        # A second pass under the profiler: how much of the wall time the
        # card was busy.
        "traced_pass": traced_window(
            lambda: serve_lines(cfg, lines, out=io.StringIO(), log=quiet, device="cuda")
        ),
    })


def _kernel_record(name, source, replaces, launches, worst, main) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": worst,
        "ms": main["ms"],
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the same function
    }


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
    fwd = phase_anova(rng)
    bwd = phase_anova_bwd(rng)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train_path, valid_path = phase_data(tmp)
        tail = phase_rows_tail(rng, train_path)
        fused_tail = phase_fused_tail(rng, train_path)
        cuda_cfg, launches = phase_train(rng, tmp, train_path, valid_path)
        phase_predict(cuda_cfg)
        fused_cfg, fused_launches = phase_train(rng, tmp, train_path, valid_path, fused=True)
        phase_predict(fused_cfg, "predict_packed")
        phase_serve(rng, tmp)
    src = "fast_tffm_tpu_torch/csrc/"
    emit({"kernels": [
        _kernel_record("anova_fwd", src + "anova_fwd.cu",
                       "fast_tffm_tpu/ops/pallas_anova.py:66", launches["anova_fwd"], *fwd),
        _kernel_record("anova_bwd", src + "anova_bwd.cu",
                       "fast_tffm_tpu/ops/pallas_anova.py:91", launches["anova_bwd"], *bwd),
        _kernel_record("rows_tail_adagrad", src + "rows_tail_adagrad.cu",
                       "fast_tffm_tpu/ops/pallas_tail.py:267", launches["rows_tail"], *tail),
        _kernel_record("fused_tail_adagrad", src + "fused_tail_adagrad.cu",
                       "fast_tffm_tpu/ops/pallas_tail.py:119", fused_launches["fused_tail"],
                       *fused_tail),
    ]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"], "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
