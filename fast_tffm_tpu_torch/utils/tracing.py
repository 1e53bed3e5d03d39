"""Profiler windows, spans, counters and the JSONL metrics sink — the
counterpart of ``fast_tffm_tpu/utils/tracing.py`` on ``torch.profiler``.

  * ``WindowTracer`` — a ``torch.profiler`` trace over a bounded step
    window of a long run (``trace_dir`` + ``trace_steps``, after ``skip``
    warm-up steps), exported as a Chrome trace;
  * ``span(name)`` — the port's one span: while spans are on
    (``spans_on``), a ``record_function`` range on the host, an NVTX range
    on the card and, for a name of ``DEVICE_SPANS``, a marker kernel
    (``csrc/span_mark.cu``) at entry and exit on the current stream, so a
    CUDA graph captured with spans on carries its spans into every replay;
    while they are off, nothing but one check of the switch.
    ``step_trace(name, step)`` is the span ``name#step`` of one call;
  * counters (``count_on_device``, ``counters``): int64 tensors on the
    device, added to while spans are on, synced only by ``counters()``;
  * ``read_spans(events)`` — the device spans of a trace: each device
    operation and each idle gap put down to the innermost span it falls in
    (an operator's tool for the traces ``WindowTracer`` and
    ``profiling.StepProfiler`` write);
  * ``MetricsLogger`` — the JSONL sink under ``telemetry.RunMonitor``.

``utils/step_graph.StepGraphs`` keys its captures on the switch: a graph
captured with spans off has no marker and no counter operation, and one
captured with them on replays its markers and device counters.  The marker
library is built or loaded at the first marker.  Spans on cost a host call
per boundary in eager steps, and in a graph one marker node per boundary
(16 a step; DCN-V2's 20 + 2 a cross layer) plus the counters' few small
kernels.

``torch`` is imported inside the profiler and span helpers only:
``MetricsLogger`` (and so ``telemetry``) imports without it.
``torch.profiler`` traces do not nest: one window at a time per process.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import threading
import time

__all__ = [
    "WindowTracer", "DEVICE_SPANS", "spans_on", "spans_enabled", "span", "step_trace",
    "count_on_device", "counters", "counter_delta", "read_spans", "MetricsLogger", "export_trace",
]


def _jsonsafe(v):
    """Non-finite floats become their string names ('nan'/'inf'/'-inf'):
    Python's json would emit bare NaN/Infinity tokens, which strict JSON
    readers reject; ``float(...)`` round-trips the strings."""
    if isinstance(v, float) and not math.isfinite(v):
        return str(v)
    if isinstance(v, dict):
        return {k: _jsonsafe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonsafe(x) for x in v]
    return v


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


def export_trace(prof, out_dir: str, tag: str) -> str:
    """Write a stopped profiler's trace as ``<out_dir>/<tag>.<pid>.pt.trace.json``
    (Chrome trace format); returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


class WindowTracer:
    """Trace the step window [skip, skip + count) of a long run.

    Whole-run traces are huge and their overhead skews the throughput
    being measured, so tracing starts after ``skip`` steps (the builds,
    captures and warm-up fall outside) and stops after ``count``.  Spans
    are on from the call before the window (which captures the
    instrumented graph outside the trace) until it closes; the counters'
    change over the window is ``counters`` after ``close()``, and the
    ``monitor``'s kind=profile record ``window_stop`` (``trace_path``,
    ``counters``).  No-op when ``trace_dir`` is empty.  ``cuda`` adds the
    card's activity."""

    def __init__(self, trace_dir: str | None, *, skip: int = 5, count: int = 20,
                 cuda: bool = False, monitor=None):
        self._dir = trace_dir or None
        self._skip = skip
        self._count = count
        self._cuda = cuda
        self._monitor = monitor
        self._seen = 0
        self._prof = None
        self._spans = False  # this tracer turned spans on
        self._at_start: dict = {}
        self.path: str | None = None
        self.counters: dict = {}

    def on_step(self) -> None:
        """Call once per train call (before or after — consistency is all)."""
        if self._dir is None:
            return
        if self._prof is None and self._seen >= self._skip - 1 and not self._spans:
            spans_on(True)
            self._spans = True
        if self._prof is None and self._seen == self._skip:
            import torch.profiler

            self._at_start = counters()
            self._prof = torch.profiler.profile(activities=_activities(self._cuda))
            self._prof.start()
        elif self._prof is not None and self._seen >= self._skip + self._count:
            self.close()
        self._seen += 1

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            if self._cuda:
                import torch

                torch.cuda.synchronize()  # the window's last launches finish inside the trace
            prof.stop()
            self.counters = counter_delta(self._at_start)
            self.path = export_trace(prof, self._dir, "window")
            if self._monitor is not None:
                try:
                    self._monitor.emit("profile", step=self._seen, program="trace", flops=None,
                                       bytes_accessed=None, event="window_stop",
                                       trace_path=self.path, counters=self.counters)
                except (OSError, ValueError):
                    pass  # a full metrics disk must not kill the trace
            self._dir = None  # one window per run
        if self._spans:
            spans_on(False)
            self._spans = False


# --- spans ---------------------------------------------------------------

# The spans whose boundaries also go to the device, by marker ID
# (``csrc/span_mark.cu`` has 16).  Each step body opens the same ones:
# ``step`` around a step of ``trainer.k_step_loop``; inside it ``batch``
# (the resident batch's ``index_select``s), ``gather`` (the table rows),
# ``forward`` (scorer, L2, loss), ``backward`` (``torch.autograd.grad``),
# ``sort`` (``torch.sort`` of the ids), ``tail`` (the Adagrad kernel) and
# ``dense`` (the dense leaves' Adagrad, DeepFM and DCN-V2); DCN-V2 adds
# ``cross`` (its cross network inside ``forward``, and ``ops/dcn.py``'s
# backward kernel inside ``backward``) and ``mlp`` (its top MLP inside
# ``forward``).  New names go at the end: a name's ID is its marker's.  Any
# other name is a host span only (``step_graph.call``, ``step_graph.capture``).
DEVICE_SPANS = ("step", "batch", "gather", "forward", "backward", "sort", "tail", "dense",
                "cross", "mlp")
_IDS = {name: i for i, name in enumerate(DEVICE_SPANS)}
_MARK = re.compile(r"span_mark<(\d+), (\d+)>")  # as the profiler names it

_on = False
_device_counts: dict[tuple, object] = {}  # (name, device) -> int64 tensor
_marker = None  # the marker library's launch function, loaded on first use


def spans_on(flag: bool) -> None:
    """Turn spans (and the counters) on or off for the whole process."""
    global _on
    _on = bool(flag)


def spans_enabled() -> bool:
    return _on


class _Span:
    """``record_function`` plus, once CUDA is initialised, an NVTX range and
    (for a name of ``DEVICE_SPANS``) a marker kernel at entry and at exit
    on the current stream."""

    __slots__ = ("name", "_id", "_rf", "_cuda")

    def __init__(self, name: str):
        self.name = name
        self._id = _IDS.get(name)

    def __enter__(self):
        import torch

        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._cuda = torch.cuda.is_initialized()
        if self._cuda:
            torch.cuda.nvtx.range_push(self.name)
            if self._id is not None:
                _mark(self._id, 1)
        return self

    def __exit__(self, *exc):
        if self._cuda:
            import torch

            if self._id is not None:
                _mark(self._id, 0)
            torch.cuda.nvtx.range_pop()
        return self._rf.__exit__(*exc)


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks ``name`` on the profiler timeline while
    spans are on, and does nothing (one check of the switch) while they
    are off."""
    return _Span(name) if _on else _OFF


def step_trace(name: str, step: int):
    """Annotate one train/eval call on the profiler timeline (``name#step``)."""
    return span(f"{name}#{step}")


def _mark(span_id: int, begin: int) -> None:
    """Launch the marker kernel ``span_mark<span_id, begin>`` on the current
    stream (inside a capture: record it)."""
    global _marker
    import torch

    if _marker is None:
        from fast_tffm_tpu_torch.ops import kernel_build

        fn = kernel_build.load("span_mark").span_mark_launch
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _marker = fn
    rc = _marker(span_id, begin, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"span marker launch failed with CUDA error {rc}")


def count_on_device(name: str, value) -> None:
    """Add the 0-d integer tensor ``value`` to the counter ``name`` on its
    device while spans are on, with no host sync: a persistent int64
    tensor, which a CUDA graph captured here adds into at every replay (a
    capture's warm-up run, which creates the tensor, adds once too)."""
    if not _on:
        return
    import torch

    key = (name, value.device)
    total = _device_counts.get(key)
    if total is None:
        if value.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} is first used inside a CUDA-graph "
                               "capture; run the body once before capturing it")
        total = _device_counts[key] = torch.zeros((), dtype=torch.int64, device=value.device)
    total.add_(value)


def counters() -> dict:
    """A snapshot of every counter, its parts on every device added up; the
    one call here that waits for the card (for the work queued on the
    current stream).

    * ``tail.unique_rows``: the distinct ids of each step's M occurrences
      (padding id 0 included), the id changes along the sort's output + 1.

    Counted only while spans are on; read the change over a window of
    calls (``counter_delta``)."""
    out: dict[str, int] = {}
    for (name, _), total in list(_device_counts.items()):
        out[name] = out.get(name, 0) + int(total.item())
    return out


def counter_delta(before: dict) -> dict:
    """Each counter's change since the snapshot ``before``."""
    return {name: n - before.get(name, 0) for name, n in counters().items()}


# --- reading spans from a trace --------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _marker_of(name: str):
    """(span name, begin) of a marker kernel's name
    (``void (anonymous namespace)::span_mark<ID, 1|0>()``); None for any
    other."""
    m = _MARK.search(name)
    return None if m is None else (DEVICE_SPANS[int(m.group(1))], m.group(2) == "1")


def read_spans(events: list, start: float | None = None, end: float | None = None) -> dict:
    """Device spans of a ``torch.profiler`` Chrome trace's ``events`` (its
    ``traceEvents``), over the device operations that start in
    [``start``, ``end``) µs (default: all).

    The markers of each stream open and close its spans; every other
    operation goes to the innermost span open on its stream when it
    starts, and every idle gap (outside the union of all operations) to the
    innermost span open when it begins, the most recently opened across
    streams.  A marker that closes a span it never saw open (the trace
    began inside it) is skipped.  Returns::

        {"spans": {name: {"n", "device_ms", "idle_ms"}},  # innermost only
         "markers": {"n", "device_ms"},
         "outside": {"device_ms", "idle_ms"},  # in no span
         "host": {name: {"n", "ms"}}}  # host spans of the same names

    ``n`` counts a span's openings; ``host`` holds the user annotations named
    by ``DEVICE_SPANS`` or starting ``step_graph.``."""
    lo = -math.inf if start is None else start
    hi = math.inf if end is None else end
    ops, host = [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        name, ts, dur = str(e.get("name", "")), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS and lo <= ts < hi:
            ops.append((ts, ts + dur, (e.get("pid"), e.get("tid")), name))
        elif cat == "user_annotation" and (name in _IDS or name.startswith("step_graph.")):
            h = host.setdefault(name, {"n": 0, "ms": 0.0})
            h["n"] += 1
            h["ms"] += dur / 1e3
    ops.sort(key=lambda op: op[0])
    spans: dict[str, dict] = {}
    markers = {"n": 0, "device_ms": 0.0}
    outside = {"device_ms": 0.0, "idle_ms": 0.0}
    stacks: dict[tuple, list] = {}
    opened: list = []  # (stream, name) in order of opening, still open

    def bucket(name):
        return spans.setdefault(name, {"n": 0, "device_ms": 0.0, "idle_ms": 0.0})

    busy_until = None
    for s, e, stream, name in ops:
        if busy_until is not None and s > busy_until:
            gap = (s - busy_until) / 1e3
            if opened:
                bucket(opened[-1][1])["idle_ms"] += gap
            else:
                outside["idle_ms"] += gap
        busy_until = e if busy_until is None else max(busy_until, e)
        stack = stacks.setdefault(stream, [])
        mark = _marker_of(name)
        if mark is None:
            if stack:
                bucket(stack[-1])["device_ms"] += (e - s) / 1e3
            else:
                outside["device_ms"] += (e - s) / 1e3
            continue
        markers["n"] += 1
        markers["device_ms"] += (e - s) / 1e3
        span_name, begin = mark
        if begin:
            stack.append(span_name)
            opened.append((stream, span_name))
            bucket(span_name)["n"] += 1
        elif span_name in stack:
            while stack:  # a span left open inside it closes with it
                top = stack.pop()
                opened.remove((stream, top))
                if top == span_name:
                    break
    return {"spans": spans, "markers": markers, "outside": outside, "host": host}


class MetricsLogger:
    """Append-only JSONL metrics sink (a no-op when ``path`` is empty).

    Thread-safe: the telemetry watchdog writes from its own thread beside
    the training loop's records, and two interleaved half-lines would corrupt
    the file for every reader (tools/report.py)."""

    def __init__(self, path: str | None):
        self._f = None
        self._lock = threading.Lock()
        if path:
            dirpart = os.path.dirname(path)
            if dirpart:
                os.makedirs(dirpart, exist_ok=True)
            self._f = open(path, "a", buffering=1)

    @property
    def active(self) -> bool:
        return self._f is not None

    def log(self, **fields) -> None:
        if self._f is None:  # cheap no-op path; re-checked under the lock
            return
        fields.setdefault("ts", round(time.time(), 3))
        line = json.dumps(_jsonsafe(fields), allow_nan=False) + "\n"
        with self._lock:
            if self._f is None:
                return
            self._f.write(line)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
