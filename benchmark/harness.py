"""One run of one cell: set-up, the measured window (or, with ``--trace 1``,
a traced stretch), the comparison with the plain reference, and the
result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``, and the reference
``reference/<model>.py``.

Set-up (counted in ``setup_s``): the epoch drawn on the card from the
seed, the benchmark's starting weights, the port's state and K-step call
(``programs/rows.py``), the checked first calls (``check.check_plan``,
each followed by a snapshot of the state for the comparison), and
``WARMUP_CALLS`` calls.  The window then issues K-step calls over the
epoch's chunks, in order and epoch after epoch, for ``--seconds``, keeping
at most ``IN_FLIGHT`` calls queued ahead of the card, and closes with
``Program.sync``.  This loop stands in for ``training._run_training``
without its logging, validation and saves.  With ``--trace 1`` the same
window runs untraced and is followed by a traced stretch of whole calls
(about ``TRACE_TARGET_S``), closed the same way, which the per-layer
metrics read.  The result also gives how the window's device time per
call moved (``calls``: ``call_levels``), since the card runs the first
seconds of some windows in a slower mode.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import check, devtrace, roofline, traffic
from benchmark.programs.rows import Program
from benchmark.readings import LayerReading, WindowReading
from benchmark.reference import common as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_tffm_tpu")
WARMUP_CALLS = 4
IN_FLIGHT = 3  # calls queued ahead of the card in the window
TRACE_TARGET_S = 1.0  # the traced stretch: whole calls covering about this long
SLOW_STEP = 0.015  # a window call this much slower than the 10th percentile counts as slow

__all__ = ["load_spec", "cell_shape", "prepare", "release", "run_cell", "forbidden_modules", "main"]


def load_spec(workload: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic mix, and the metrics it
    reports, from ``BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in e2e_names else [])]
    return {"cell": cell, "config": cfg, "mix": traffic.load_mix(cell["traffic"], HERE),
            "end_to_end": e2e, "per_layer": layer}


def _reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``fast_tffm_tpu_torch`` is not ``fast_tffm_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _drive(prog, chunks, start: int, *, calls: int | None = None, seconds: float | None = None,
           span=None):
    """Issue K-step calls over ``chunks`` from chunk ``start`` until
    ``calls`` calls or ``seconds`` of wall time, at most ``IN_FLIGHT``
    queued ahead of the card; then close with ``prog.sync``.  Returns
    (calls, wall seconds, the calls' losses, the next chunk, the device
    milliseconds of each call after the first, from CUDA events between
    calls; empty off the card)."""
    cuda = prog.device.type == "cuda"
    events, losses = [], []
    n, i = 0, start
    t0 = time.perf_counter()
    deadline = t0 + (seconds if seconds is not None else math.inf)
    while (calls is None or n < calls):
        with span("call"):
            losses.append(prog.call(chunks[i % len(chunks)]))
        i, n = i + 1, n + 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if len(events) > IN_FLIGHT:
                events[-IN_FLIGHT - 1].synchronize()
        if time.perf_counter() >= deadline:
            break
    with span("sync"):
        prog.sync()
    wall = time.perf_counter() - t0
    call_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return n, wall, losses, i % len(chunks), call_ms


def call_levels(call_ms: list[float]) -> dict | None:
    """How the window's device time per call moved: its 10th and 90th
    percentile, the share of calls more than ``SLOW_STEP`` above the 10th
    percentile, and the device seconds into the window at which the last
    of those ended (0 where none).  The card runs some windows' first
    seconds in a slower mode; this is its share of the run."""
    if len(call_ms) < 10:
        return None
    dec = statistics.quantiles(call_ms, n=10)
    slow = [j for j, ms in enumerate(call_ms) if ms > dec[0] * (1 + SLOW_STEP)]
    return {"device_ms_p10": dec[0], "device_ms_p90": dec[-1],
            "slow_share": len(slow) / len(call_ms),
            "last_slow_s": sum(call_ms[:slow[-1] + 1]) / 1e3 if slow else 0.0}


def _power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _clock(dev) -> float:
    """The host clock once the card has done what was queued."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def cell_shape(spec: dict) -> tuple[int, int, int]:
    """(batch, slots, K) of the cell."""
    cfg, mix = spec["config"], spec["mix"]
    return (int(mix["batch_size"] or cfg["batch_size"]), int(cfg["max_nnz"]),
            int(cfg["steps_per_call"]))


def prepare(spec: dict, seed: int, dev, marks: list | None = None):
    """The set-up before the warm-up: the epoch, the starting weights, the
    port's ``Program`` and its checked first calls.  Returns (program,
    epoch, the benchmark's copy of the checked batches, the port's
    losses and snapshots of them).  Appends (stage, host clock at its
    end) to ``marks``."""
    marks = [] if marks is None else marks
    cfg, mix, name = spec["config"], spec["mix"], spec["cell"]["name"]
    b, n_fields, k = cell_shape(spec)
    epoch = traffic.make_epoch(mix, batch_size=b, n_fields=n_fields,
                               vocabulary_size=int(cfg["vocabulary_size"]), seed=seed, device=dev)
    marks.append(("epoch", _clock(dev)))
    plan = check.check_plan(k)
    n_checked = plan[-1][-1] + 1
    if epoch.batches < n_checked or epoch.batches % k:
        raise ValueError(f"{name}: {epoch.batches} batches an epoch; the checked calls take "
                         f"{n_checked} and the window whole chunks of {k}")
    # The benchmark's own copy of the inputs the comparison follows.
    checked = [{key: t.clone() for key, t in epoch.batch(i).items()} for i in range(n_checked)]
    ck = torch.unique(torch.cat([c["ids"].reshape(-1) for c in checked]).long())
    table, dense = ref.draw_table(cfg, seed, dev), ref.draw_dense(cfg, seed, dev)
    marks.append(("weights", _clock(dev)))
    prog = Program(cfg, epoch, table, dense, dev)
    del table, dense
    marks.append(("program", _clock(dev)))
    losses, snaps, done = [], {}, 0
    for idxs in plan:
        losses += prog.call(torch.tensor(idxs, dtype=torch.int64, device=dev)).tolist()
        done += len(idxs)
        snaps[done] = prog.snapshot(ck)
    marks.append(("checked_calls", _clock(dev)))
    return prog, epoch, checked, {"losses": losses, "snaps": snaps}


def release(dev) -> None:
    """Return the freed port state's memory to the card."""
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             limits: dict | None = None, log=print) -> dict:
    """One run of the cell on ``device``; returns the result object
    (``checks`` last).  ``limits`` defaults to ``limits/<cell>.json``."""
    cfg, mix, name = spec["config"], spec["mix"], spec["cell"]["name"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    span = torch.profiler.record_function
    limits = limits if limits is not None else check.load_limits(name, HERE)

    b, n_fields, k = cell_shape(spec)
    marks = [("start", time.perf_counter())]
    with span("setup"):
        prog, epoch, checked, first = prepare(spec, seed, dev, marks)
        chunks = prog.chunks()
        n, warm_s, _, at, _ = _drive(prog, chunks, 0, calls=WARMUP_CALLS, span=span)
        per_call_s = warm_s / n
    setup_s = time.perf_counter() - t_start
    marks.append(("warmup", time.perf_counter()))
    log("setup stages (s): imports " + repr(marks[0][1] - t_start) + ", " + ", ".join(
        f"{m} {t - marks[i][1]!r}" for i, (m, t) in enumerate(marks[1:])), file=sys.stderr)

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": {}}
    if not trace:
        calls, wall, window_losses, _, call_ms = _drive(prog, chunks, at, seconds=seconds,
                                                        span=span)
        w = WindowReading(setup_s=setup_s, window_s=wall, calls=calls, steps=calls * k,
                          examples=calls * k * b)
        for m in spec["end_to_end"]:
            v = _reader(m["name"])(w)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # The window untraced, then a traced stretch of whole calls from
        # where it stopped: the trace reads the state a window ends in.
        _, _, window_losses, at, call_ms = _drive(prog, chunks, at, seconds=seconds, span=span)
        calls = max(2, math.ceil(TRACE_TARGET_S / per_call_s))
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as p:
            with span("window"):
                calls, _, traced_losses, _, _ = _drive(prog, chunks, at, calls=calls, span=span)
        window_losses += traced_losses
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            p.export_chrome_trace(path)
            tr = devtrace.from_events(devtrace.load(path))
        traced = [int(i) for j in range(at, at + calls) for i in chunks[j % len(chunks)].tolist()]
        uniq = {i: int(torch.unique(epoch.ids[i * b:(i + 1) * b]).numel()) for i in set(traced)}
        kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        with open(os.path.join(HERE, "kernels.json")) as f:
            groups = json.load(f)["groups"]
        r = LayerReading(
            trace=tr, kernels=groups, steps=calls * k, batch_size=b, n_fields=n_fields,
            unique_per_step=[uniq[i] for i in traced], row_dim=ref.row_dim(cfg),
            accum_width=ref.accum_width(cfg), dense_numel=sum(
                math.prod(s) for s in ref.model_module(cfg).dense_shapes(cfg).values()),
            flops_per_step=ref.model_module(cfg).step_flops(cfg, b, n_fields),
            peaks=roofline.PEAKS.get(kind, {}),
        )
        for m in spec["per_layer"]:
            v = _reader(m["name"])(r)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"].update(busy_s=r.busy_s, window_s=r.window_s)
        result["breakdown"] = {"device_ops": devtrace.device_ops(tr),
                               "idle_gaps": devtrace.idle_causes(tr)}
        if r.peaks:
            least = roofline.step_least_s(b, n_fields, statistics.median_low(r.unique_per_step),
                                          r.row_dim, r.accum_width, r.dense_numel,
                                          r.flops_per_step, r.peaks)
            log(f"mfu bound: {least[1]} ({1e6 * least[0]:.3f} us a step at the median U); "
                f"card: {_power_limit()}", file=sys.stderr)
    steps = torch.cat(window_losses)
    result["attempted"] = int(steps.numel())
    result["failed"] = int((~torch.isfinite(steps)).sum())
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(spec["cell"]["chips"]),
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0,
        **result["device"],
    }

    levels = call_levels(call_ms)
    if levels is not None:
        result["calls"] = levels
        log("window calls: " + ", ".join(f"{k} {v!r}" for k, v in levels.items()),
            file=sys.stderr)

    # The window has closed and the peak is read: free the port's state,
    # then follow the checked steps with the reference.
    del prog, epoch, chunks, window_losses, steps
    release(dev)
    t_ref = time.perf_counter()
    followed = ref.reference_steps(cfg, checked, seed, dev, ref.config_precision(cfg),
                                   check.snapshot_steps(k))
    numbers = check.readings(cfg, first, followed)
    ok, table = check.judge(numbers, limits)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s for {len(checked)} steps",
        file=sys.stderr)
    result["correct"] = bool(ok and result["failed"] == 0)
    result["checks"] = table
    return result


def _parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    t_main = time.perf_counter()
    args = _parse(argv)
    spec = load_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    print(f"process start (s): python imports {t_main - t_start!r}, the card found "
          f"{time.perf_counter() - t_main!r}", file=sys.stderr)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 4
    for n, v in result["checks"].items():
        print(f"check {n} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
