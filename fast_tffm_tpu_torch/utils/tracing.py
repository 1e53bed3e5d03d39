"""Profiler windows, step annotation and the JSONL metrics sink — the
counterpart of ``fast_tffm_tpu/utils/tracing.py`` on ``torch.profiler``.

  * ``maybe_trace(trace_dir)`` — a ``torch.profiler`` trace of whatever it
    scopes when ``trace_dir`` is set, exported as a Chrome trace there;
  * ``WindowTracer`` — the same over a bounded step window of a long run
    (``trace_dir`` + ``trace_steps``, after ``skip`` warm-up steps);
  * ``step_trace(name, step)`` — a ``record_function`` range per step (and
    an NVTX range on the card), so steps line up on the trace's timeline;
  * ``MetricsLogger`` — the JSONL sink under ``telemetry.RunMonitor``.

``torch`` is imported inside the profiler helpers only: ``MetricsLogger``
(and so ``telemetry``) imports without it.  ``torch.profiler`` traces do
not nest: one window at a time per process.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time

__all__ = ["maybe_trace", "WindowTracer", "step_trace", "MetricsLogger", "export_trace"]


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


def _cuda_live() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def export_trace(prof, out_dir: str, tag: str) -> str:
    """Write a stopped profiler's trace as ``<out_dir>/<tag>.<pid>.pt.trace.json``
    (Chrome trace format); returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """A torch.profiler trace of the scoped block into ``trace_dir`` when
    set; a no-op otherwise.  Prefer ``WindowTracer`` for training runs."""
    if not trace_dir:
        yield
        return
    import torch.profiler

    with torch.profiler.profile(activities=_activities(_cuda_live())) as prof:
        yield
    export_trace(prof, trace_dir, "trace")


class WindowTracer:
    """Trace the step window [skip, skip + count) of a long run.

    Whole-run traces are huge and their overhead skews the throughput
    being measured, so tracing starts after ``skip`` steps (the builds,
    captures and warm-up fall outside) and stops after ``count``.  No-op
    when ``trace_dir`` is empty.  ``cuda`` adds the card's activity."""

    def __init__(self, trace_dir: str | None, *, skip: int = 5, count: int = 20,
                 cuda: bool = False):
        self._dir = trace_dir or None
        self._skip = skip
        self._count = count
        self._cuda = cuda
        self._seen = 0
        self._prof = None
        self.path: str | None = None

    def on_step(self) -> None:
        """Call once per train call (before or after — consistency is all)."""
        if self._dir is None:
            return
        if self._prof is None and self._seen == self._skip:
            import torch.profiler

            self._prof = torch.profiler.profile(activities=_activities(self._cuda))
            self._prof.start()
        elif self._prof is not None and self._seen >= self._skip + self._count:
            self.close()
        self._seen += 1

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
            self.path = export_trace(prof, self._dir, "window")
            self._dir = None  # one window per run


class _StepRange:
    """``record_function`` plus, on the card, an NVTX range."""

    def __init__(self, label: str, cuda: bool):
        import torch.profiler

        self._rf = torch.profiler.record_function(label)
        self._label = label
        self._cuda = cuda

    def __enter__(self):
        self._rf.__enter__()
        if self._cuda:
            import torch

            torch.cuda.nvtx.range_push(self._label)
        return self

    def __exit__(self, *exc):
        if self._cuda:
            import torch

            torch.cuda.nvtx.range_pop()
        return self._rf.__exit__(*exc)


def step_trace(name: str, step: int, cuda: bool = False):
    """Annotate one train/eval call on the profiler timeline (``name#step``)."""
    return _StepRange(f"{name}#{step}", cuda)


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
