"""Reading a ``torch.profiler`` trace (its Chrome-trace export) of the traced
stretch of a run.

The stretch is the host span ``window`` (a ``record_function`` the harness
opens around its calls and the closing sync).  Device operations
(kernels, copies, sets) are clipped to it.  The device is busy where at
least one operation runs: the **union** of their intervals, so operations
that overlap (side streams, a set under a kernel) count once.  Idle gaps
are the stretch's time outside that union; each is put down to what the
host was doing when it began, the innermost host event of the window's
thread that spans its start.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

__all__ = ["DEVICE_CATS", "HOST_CATS", "Trace", "load", "from_events", "union", "busy_s", "gaps",
           "match", "group_seconds", "device_ops", "idle_causes"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 120  # a device operation's name as the breakdown gives it


@dataclasses.dataclass
class Trace:
    start: float  # µs, the window span's start
    end: float  # µs, its end
    device: list  # (name, start, end), clipped to the window, sorted by start
    host: list  # (name, start, end) of the window's thread

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6


def load(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])


def from_events(events: list[dict], window: str = "window") -> Trace:
    """The traced stretch of ``events``: the last host span named
    ``window``.  Raises when there is none."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == window
             and str(e.get("cat", "")).lower() == "user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no host span {window!r}")
    w = spans[-1]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            lo, hi = max(s, t0), min(s + d, t1)
            if hi > lo:
                device.append((str(e.get("name", "")), lo, hi))
        elif cat in HOST_CATS and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid"):
            host.append((str(e.get("name", "")), s, s + d))
    device.sort(key=lambda x: x[1])
    return Trace(start=t0, end=t1, device=device, host=host)


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals of the (…, start, end) tuples."""
    out: list[list[float]] = []
    for s, e in sorted((iv[-2], iv[-1]) for iv in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in union(trace.device)) / 1e6


def gaps(trace: Trace) -> list[tuple[float, float]]:
    """The stretch's idle intervals (µs), outside the device's union."""
    out, at = [], trace.start
    for s, e in union(trace.device):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if trace.end > at:
        out.append((at, trace.end))
    return out


def match(name: str, patterns) -> bool:
    return any(p in name for p in patterns)


def group_seconds(trace: Trace, patterns) -> float:
    """Device seconds of the operations whose name holds any of
    ``patterns`` (summed durations: one group's kernels run one at a
    time on the step's stream)."""
    return sum(e - s for name, s, e in trace.device if match(name, patterns)) / 1e6


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """[name, seconds] of the operations that took most device time."""
    by: dict[str, float] = {}
    for name, s, e in trace.device:
        key = name[:NAME_CHARS]
        by[key] = by.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_causes(trace: Trace, top: int = 10) -> list[list]:
    """[host event, idle seconds]: the idle gaps summed by the innermost
    host event spanning each gap's start, the largest first ("idle" where
    the host was in none)."""
    host = sorted(trace.host, key=lambda h: (h[1], -(h[2] - h[1])))
    starts = [h[1] for h in host]
    by: dict[str, float] = {}
    stack: list[tuple] = []
    nxt = 0
    for gs, ge in gaps(trace):
        hi = bisect.bisect_right(starts, gs)
        while nxt < hi:
            while stack and stack[-1][2] <= host[nxt][1]:
                stack.pop()
            stack.append(host[nxt])
            nxt += 1
        while stack and stack[-1][2] <= gs:
            stack.pop()
        name = stack[-1][0] if stack else "idle"
        by[name] = by.get(name, 0.0) + (ge - gs) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
