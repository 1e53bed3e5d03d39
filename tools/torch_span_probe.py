"""The port's spans at a benchmark cell's size, on one card.

    python tools/torch_span_probe.py --cell fm2_criteo1tb.fields --seed 7 \
        [--window-s 6] [--out FILE]

Run from the root of a checkout (it imports ``benchmark/harness.py`` and the
``fast_tffm_tpu_torch`` beside it; no JAX).  It prepares the cell as the
benchmark does (``harness.prepare``: the configuration, the traffic drawn
from ``--seed``, the K-step program) and then, on the card:

* counts the device operations of a replay with spans off (three calls
  traced);
* times windows of ``--window-s`` seconds with spans off and on, in the
  order off on on off off on on off (each mode's first call, which captures
  its graph where the mode is new, falls outside the window): examples/s,
  the host's ms per call (the call alone) and the device's ms per call
  (CUDA events between calls, median and p10);
* turns spans on, makes one call (the instrumented capture), and traces a
  stretch of about a second of whole calls under a host span ``spans``:
  ``tracing.read_spans`` over it gives each span's device and idle ms a
  step, the markers' ms, the operations outside any span, and the host's
  ``step_graph.call``; the counter ``tail.unique_rows`` over the stretch is
  set beside the sum of ``torch.unique``'s count over the same batches
  (the harness's U), and the spans' device and idle time plus the markers'
  beside the stretch's device extent.

It prints each window on stderr and writes one JSON object to ``--out``
(default stdout).  A checkout without spans (no ``tracing.spans_on``) gets
the off windows only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MODES = ("off", "on", "on", "off", "off", "on", "on", "off")


def _traced(fn):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return out, json.load(f)["traceEvents"]


def _device_ops(events):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True, help="a workload of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window-s", type=float, default=6.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    sys.path.insert(0, os.getcwd())
    import torch

    from benchmark import harness
    from fast_tffm_tpu_torch.utils import tracing

    if not torch.cuda.is_available():
        print("torch_span_probe: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.load_spec(args.cell)
    b, _, k = harness.cell_shape(spec)
    prog, epoch, _, _ = harness.prepare(spec, args.seed, dev)
    chunks = prog.chunks()
    at = 0
    has_spans = hasattr(tracing, "spans_on")

    def calls(n):
        nonlocal at
        for _ in range(n):
            prog.call(chunks[at % len(chunks)])
            at += 1
        torch.cuda.synchronize()

    def window(seconds):
        nonlocal at
        events, host = [], []
        n = 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            h = time.perf_counter()
            prog.call(chunks[at % len(chunks)])
            host.append(time.perf_counter() - h)
            at, n = at + 1, n + 1
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            if len(events) > 3:
                events[-4].synchronize()
        prog.sync()
        wall = time.perf_counter() - start
        dms = [a.elapsed_time(c) for a, c in zip(events, events[1:])]
        return {"examples_per_s": n * k * b / wall, "calls": n,
                "host_ms_per_call": 1e3 * statistics.mean(host),
                "device_ms_p10": statistics.quantiles(dms, n=10)[0],
                "device_ms_median": statistics.median(dms)}

    res = {"cell": args.cell, "seed": args.seed, "has_spans": has_spans,
           "card": torch.cuda.get_device_name(0)}
    calls(4)  # the plain capture and the allocator's warm-up
    _, events = _traced(lambda: calls(3))
    ops = _device_ops(events)
    res["ops_per_call_off"] = len(ops) / 3
    res["kernels_per_call_off"] = sum(e["cat"] == "kernel" for e in ops) / 3

    res["windows"] = []
    for mode in MODES if has_spans else ("off",) * 4:
        if has_spans:
            tracing.spans_on(mode == "on")
        calls(1)  # a capture where the mode is new
        w = window(args.window_s)
        w["mode"] = mode
        res["windows"].append(w)
        print(args.cell, mode, json.dumps(w), file=sys.stderr, flush=True)

    if has_spans:
        tracing.spans_on(True)
        calls(1)
        per_call_s = statistics.median(w["device_ms_median"] for w in res["windows"]) / 1e3
        n = max(2, math.ceil(1.0 / per_call_s))
        first = at
        before = tracing.counters()

        def stretch():
            with torch.profiler.record_function("spans"):
                calls(n)

        _, events = _traced(stretch)
        counted = tracing.counter_delta(before)
        tracing.spans_on(False)
        host = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == "spans"][-1]
        lo = float(host["ts"])
        r = tracing.read_spans(events, start=lo, end=lo + float(host["dur"]))
        ops = _device_ops(events)
        extent_ms = (max(float(e["ts"]) + float(e["dur"]) for e in ops)
                     - min(float(e["ts"]) for e in ops)) / 1e3
        batches = [int(i) for j in range(first, first + n)
                   for i in chunks[j % len(chunks)].tolist()]
        u = [int(torch.unique(epoch.ids[i * b:(i + 1) * b]).numel()) for i in batches]
        sp = r["spans"]
        # the steps the trace holds: it may lose its first events, markers
        # and kernels alike (the counter saw all n * k)
        steps = max(d["n"] for d in sp.values())
        tail_ms = sp["sort"]["device_ms"] + sp["tail"]["device_ms"]
        call = r["host"]["step_graph.call"]
        res["stretch"] = {
            "calls": n, "steps": n * k, "steps_traced": steps, "extent_ms": extent_ms, "read": r,
            "per_step_ms": {s: {"device": d["device_ms"] / steps, "idle": d["idle_ms"] / steps}
                            for s, d in sp.items()},
            "markers_ms_per_step": r["markers"]["device_ms"] / steps,
            "counters": counted, "harness_u_sum": sum(u),
            "harness_u_median": statistics.median_low(u),
            "ops_per_call_on": len(ops) / n,
            "tail_ms_per_step": tail_ms / steps,
            "tail_ns_per_row": 1e6 * (tail_ms / steps) / (counted["tail.unique_rows"] / (n * k)),
            "host_ms_per_call": call["ms"] / call["n"],
            "spanned_ms": sum(d["device_ms"] + d["idle_ms"] for d in sp.values())
            + r["markers"]["device_ms"],
        }
        print(args.cell, "stretch", json.dumps(
            {key: v for key, v in res["stretch"].items() if key != "read"}),
            file=sys.stderr, flush=True)
    res["seconds"] = time.perf_counter() - t0
    text = json.dumps(res, indent=1)
    if args.out:
        tmp = f"{args.out}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text + "\n")
        os.replace(tmp, args.out)  # whole or not at all
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
