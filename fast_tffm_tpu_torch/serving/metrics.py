"""Serving-side metrics: latency histograms, occupancy, shed counters.

A copy of ``fast_tffm_tpu/serving/metrics.py`` without the parts of later
slices: the reload, delta and freshness counters (hot reload) and
``log_to`` (RunMonitor telemetry).  The snapshot's remaining keys and
their meaning are unchanged.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["LatencyHistogram", "ServingMetrics"]


class LatencyHistogram:
    """Fixed log-spaced latency histogram with interpolated quantiles.

    Bins span [lo, hi) seconds geometrically (default 10µs..100s, 120
    bins → ~13% resolution per bin); samples outside clamp to the edge
    bins, and exact min/max/sum ride along so the snapshot never lies
    about the tails' extremes.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 100.0, bins: int = 120):
        if not (0 < lo < hi) or bins < 2:
            raise ValueError(f"bad histogram spec lo={lo} hi={hi} bins={bins}")
        self._edges = np.geomspace(lo, hi, bins + 1)
        self._counts = np.zeros(bins, np.int64)
        self._n = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = 0.0

    def add(self, seconds: float) -> None:
        self.add_many(seconds, 1)

    def add_many(self, seconds: float, k: int) -> None:
        """``k`` samples of the same value in one bin update."""
        if k <= 0:
            return
        i = int(np.searchsorted(self._edges, seconds, side="right")) - 1
        self._counts[min(max(i, 0), self._counts.size - 1)] += k
        self._n += k
        self._sum += seconds * k
        self._min = min(self._min, seconds)
        self._max = max(self._max, seconds)

    @property
    def count(self) -> int:
        return self._n

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` (log-interpolated inside the hit bin);
        nan when empty.  Clamped by the exact min/max."""
        if self._n == 0:
            return float("nan")
        target = q * self._n
        cum = np.cumsum(self._counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, self._counts.size - 1)
        prev = float(cum[i - 1]) if i > 0 else 0.0
        inbin = float(self._counts[i])
        frac = (target - prev) / inbin if inbin > 0 else 0.0
        lo, hi = self._edges[i], self._edges[i + 1]
        v = float(lo * (hi / lo) ** min(max(frac, 0.0), 1.0))
        return min(max(v, self._min), self._max)

    def snapshot(self) -> dict:
        """{count, mean, p50, p95, p99, max} in MILLISECONDS."""
        if self._n == 0:
            return {"count": 0}
        ms = 1e3
        return {
            "count": self._n,
            "mean": round(self._sum / self._n * ms, 3),
            "p50": round(self.quantile(0.50) * ms, 3),
            "p95": round(self.quantile(0.95) * ms, 3),
            "p99": round(self.quantile(0.99) * ms, 3),
            "max": round(self._max * ms, 3),
        }


class ServingMetrics:
    """Aggregate serving counters + per-stage latency histograms.

    Stages: ``queue`` (submit → flush start), ``compute`` (dispatch →
    scores on the host, whole flush), ``total`` (submit → future resolved,
    what a caller feels).  One lock covers submitters and the collector.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.queue = LatencyHistogram()
        self.compute = LatencyHistogram()
        self.total = LatencyHistogram()
        self.requests = 0
        self.rejected = 0
        self.flushes = 0
        self.deadline_drops = 0  # requests shed at flush past their own deadline
        self.drops_by_class: dict[str, int] = {}
        self.sheds_by_class: dict[str, int] = {}  # submit-side rejects + evictions
        self.evicted = 0  # queued requests evicted by a higher-class arrival
        self.class_total: dict[str, LatencyHistogram] = {}
        self.flushes_deadline = 0  # timer fired before max_batch filled
        self.flushes_full = 0  # max_batch filled before the timer
        self.rows = 0  # real rows scored (excl. bucket padding)
        self.padded_rows = 0  # bucket-padding rows scored and discarded
        self.bucket_rows: dict[int, int] = {}
        self.bucket_padded: dict[int, int] = {}

    @staticmethod
    def _class_key(klass: str) -> str:
        return klass or "default"

    def on_submit(self, accepted: bool, klass: str = "") -> None:
        with self._lock:
            self.requests += 1
            if not accepted:
                self.rejected += 1
                k = self._class_key(klass)
                self.sheds_by_class[k] = self.sheds_by_class.get(k, 0) + 1

    def on_evict(self, klass: str = "") -> None:
        """A QUEUED request was shed to admit a higher-class arrival."""
        with self._lock:
            self.evicted += 1
            k = self._class_key(klass)
            self.sheds_by_class[k] = self.sheds_by_class.get(k, 0) + 1

    def on_deadline_drop(self, klass: str = "") -> None:
        """A request's own deadline expired before scoring."""
        with self._lock:
            self.deadline_drops += 1
            k = self._class_key(klass)
            self.drops_by_class[k] = self.drops_by_class.get(k, 0) + 1

    def on_flush(
        self,
        bucket: int,
        n_rows: int,
        queue_waits: list[float],
        compute_s: float,
        total_s: list[float],
        deadline_fired: bool,
        classes: list[str] | None = None,
    ) -> None:
        """``queue_waits``/``total_s``/``classes`` are parallel per-request lists."""
        with self._lock:
            self.flushes += 1
            if deadline_fired:
                self.flushes_deadline += 1
            else:
                self.flushes_full += 1
            self.rows += n_rows
            self.padded_rows += bucket - n_rows
            self.bucket_rows[bucket] = self.bucket_rows.get(bucket, 0) + n_rows
            self.bucket_padded[bucket] = self.bucket_padded.get(bucket, 0) + (bucket - n_rows)
            self.compute.add(compute_s)
            for w in queue_waits:
                self.queue.add(w)
            for i, t in enumerate(total_s):
                self.total.add(t)
                if classes is not None:
                    k = self._class_key(classes[i])
                    h = self.class_total.get(k)
                    if h is None:
                        h = self.class_total[k] = LatencyHistogram()
                    h.add(t)

    def snapshot(self) -> dict:
        """One flat dict (JSON-ready).  Latencies in ms; occupancy in [0, 1]."""
        with self._lock:
            scored = self.rows + self.padded_rows
            return {
                "requests": self.requests,
                "rejected": self.rejected,
                "deadline_drops": self.deadline_drops,
                "deadline_drops_by_class": dict(sorted(self.drops_by_class.items())),
                "sheds_by_class": dict(sorted(self.sheds_by_class.items())),
                "evicted": self.evicted,
                "class_total_ms": {k: h.snapshot() for k, h in sorted(self.class_total.items())},
                "flushes": self.flushes,
                "flushes_deadline": self.flushes_deadline,
                "flushes_full": self.flushes_full,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_occupancy": round(self.rows / scored, 4) if scored else None,
                "bucket_rows": {str(k): v for k, v in sorted(self.bucket_rows.items())},
                "bucket_padded_rows": {str(k): v for k, v in sorted(self.bucket_padded.items())},
                "bucket_occupancy": {
                    str(k): round(self.bucket_rows.get(k, 0) / (self.bucket_rows.get(k, 0) + v), 4)
                    for k, v in sorted(self.bucket_padded.items())
                    if self.bucket_rows.get(k, 0) + v
                },
                "queue_ms": self.queue.snapshot(),
                "compute_ms": self.compute.snapshot(),
                "total_ms": self.total.snapshot(),
            }
