"""Serving-side metrics: latency histograms, occupancy, shed and reload
counters.

A copy of ``fast_tffm_tpu/serving/metrics.py``: the same counters
(``on_submit_many`` for whole frames, ``on_reload``, ``on_reload_giveup``,
``on_delta_reload``, ``on_freshness``) and the same snapshot keys, so a
port replica's ``stats`` and its ``kind=serving`` records read as the JAX
package's.  ``LatencyHistogram`` keeps fixed log-spaced bins (bounded
memory for any request count) and interpolates quantiles inside the hit
bin; ``log_to`` appends the snapshot as a ``kind=serving`` record.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["LatencyHistogram", "ServingMetrics"]


class LatencyHistogram:
    """Fixed log-spaced latency histogram with interpolated quantiles.

    Bins span [lo, hi) seconds geometrically (default 10µs..100s, 120
    bins → ~13% resolution per bin, tighter than any SLO anyone sets);
    samples outside clamp to the edge bins, and exact min/max/sum ride
    along so the snapshot never lies about the tails' extremes.
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
        """``k`` samples of the same value in one bin update — how a
        whole-frame flush records its rows without k searchsorted calls."""
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
        nan when empty.  Clamped by the exact min/max so a one-sample
        histogram reports the sample, not its bin edge."""
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
        """{count, mean, p50, p95, p99, max} in MILLISECONDS (the unit
        every serving dashboard speaks; raw seconds would misread 1000x)."""
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

    Writers: ``submit`` callers (requests/rejected) and the collector
    thread (everything else) — one lock covers both; every op is O(1) so
    contention is noise next to a flush's device dispatch.

    Stages: ``queue`` (submit → flush start: micro-batching wait +
    deadline), ``compute`` (device dispatch → scores on host, whole
    flush), ``total`` (submit → future resolved, what a caller feels).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.queue = LatencyHistogram()
        self.compute = LatencyHistogram()
        self.total = LatencyHistogram()
        self.requests = 0
        self.rejected = 0
        self.flushes = 0
        self.deadline_drops = 0  # requests shed at flush because their OWN
        #   deadline expired before scoring (pre-padding; typed `deadline`)
        self.drops_by_class: dict[str, int] = {}  # deadline drops per class
        self.sheds_by_class: dict[str, int] = {}  # overload sheds per class:
        #   submit-side rejects AND tiered evictions (typed `overloaded`)
        self.evicted = 0  # queued requests evicted by a higher-class arrival
        #   (a subset of the sheds — says tiering, not just pressure, fired)
        self.class_total: dict[str, LatencyHistogram] = {}  # per-class
        #   submit→resolved latency (the per-class p50/p99 the SLO gate reads)
        self.flushes_deadline = 0  # timer fired before max_batch filled
        self.flushes_full = 0  # max_batch filled before the timer
        self.rows = 0  # real rows scored (excl. bucket padding)
        self.padded_rows = 0  # bucket-padding rows scored and discarded
        self.reloads = 0  # FULL checkpoint re-reads swapped in
        self.reload_failures = 0  # watcher restore attempts that raised
        self.reload_giveups = 0  # checkpoint signatures abandoned after
        #   reload_max_retries consecutive failures (a persistently corrupt
        #   file; the watcher stops retrying it until a NEW write lands)
        self.delta_reloads = 0  # delta FILES applied in place (a delta
        #   swap does NOT also bump `reloads` — the counters are disjoint)
        self.bucket_rows: dict[int, int] = {}  # bucket size -> real rows
        self.bucket_padded: dict[int, int] = {}  # bucket size -> padding
        #   rows (per-bucket occupancy = rows / (rows + padded): WHERE the
        #   padding waste lives, not just that it exists)
        # Freshness SLO distributions: one sample per reload
        # swap — checkpoint publish → state applied (collector swap) and
        # publish → first score resolved against the new state.  Wall
        # clocks on both ends (the publisher stamps, this process reads),
        # so cross-host skew is the documented error bar.
        self.fresh_applied = LatencyHistogram()
        self.fresh_scored = LatencyHistogram()

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

    def on_submit_many(self, n: int, accepted: bool, klasses=None) -> None:
        """A whole frame admitted (or rejected) as one unit still counts
        as its n requests — QPS math must not depend on the wire."""
        with self._lock:
            self.requests += n
            if not accepted:
                self.rejected += n
                for klass in klasses if klasses is not None else [""] * n:
                    k = self._class_key(klass)
                    self.sheds_by_class[k] = self.sheds_by_class.get(k, 0) + 1

    def on_evict(self, klass: str = "") -> None:
        """A QUEUED request was shed to admit a higher-class arrival."""
        with self._lock:
            self.evicted += 1
            k = self._class_key(klass)
            self.sheds_by_class[k] = self.sheds_by_class.get(k, 0) + 1

    def on_deadline_drop(self, klass: str = "") -> None:
        """A request's own deadline expired before scoring — shed at the
        flush, BEFORE it could pad a bucket."""
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
        counts: list[int] | None = None,
    ) -> None:
        """``queue_waits``/``total_s``/``classes`` are parallel per-GROUP
        lists; ``counts[i]`` is how many rows share entry i (a whole
        frame's rows enter as one group — None = every group is 1 row,
        the per-request path)."""
        with self._lock:
            self.flushes += 1
            if deadline_fired:
                self.flushes_deadline += 1
            else:
                self.flushes_full += 1
            self.rows += n_rows
            self.padded_rows += bucket - n_rows
            self.bucket_rows[bucket] = self.bucket_rows.get(bucket, 0) + n_rows
            self.bucket_padded[bucket] = self.bucket_padded.get(bucket, 0) + (
                bucket - n_rows
            )
            self.compute.add(compute_s)
            if counts is None:
                counts = [1] * len(total_s)
            for w, c in zip(queue_waits, counts):
                self.queue.add_many(w, c)
            for i, t in enumerate(total_s):
                c = counts[i]
                self.total.add_many(t, c)
                if classes is not None:
                    k = self._class_key(classes[i])
                    h = self.class_total.get(k)
                    if h is None:
                        h = self.class_total[k] = LatencyHistogram()
                    h.add_many(t, c)

    def on_reload(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.reloads += 1
            else:
                self.reload_failures += 1

    def on_reload_giveup(self) -> None:
        with self._lock:
            self.reload_giveups += 1

    def on_freshness(self, applied_s: float, scored_s: float) -> None:
        """One reload swap's freshness pair (seconds since publish)."""
        with self._lock:
            self.fresh_applied.add(max(0.0, applied_s))
            self.fresh_scored.add(max(0.0, scored_s))

    def on_delta_reload(self, n_deltas: int) -> None:
        """The watcher applied ``n_deltas`` incremental checkpoint files in
        place (no full-table re-read) — counted separately from full
        reloads so a dashboard can see the cheap path is the one firing."""
        with self._lock:
            self.delta_reloads += n_deltas

    def snapshot(self) -> dict:
        """One flat dict (JSONL-ready).  Latencies in ms, keyed per stage;
        occupancy in [0, 1]; bucket_rows keyed by stringified bucket size
        (JSON objects take string keys)."""
        with self._lock:
            scored = self.rows + self.padded_rows
            return {
                "requests": self.requests,
                "rejected": self.rejected,
                "deadline_drops": self.deadline_drops,
                "deadline_drops_by_class": dict(sorted(self.drops_by_class.items())),
                "sheds_by_class": dict(sorted(self.sheds_by_class.items())),
                "evicted": self.evicted,
                "class_total_ms": {
                    k: h.snapshot() for k, h in sorted(self.class_total.items())
                },
                "flushes": self.flushes,
                "flushes_deadline": self.flushes_deadline,
                "flushes_full": self.flushes_full,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_occupancy": round(self.rows / scored, 4) if scored else None,
                "reloads": self.reloads,
                "reload_failures": self.reload_failures,
                "reload_giveups": self.reload_giveups,
                "delta_reloads": self.delta_reloads,
                "bucket_rows": {str(k): v for k, v in sorted(self.bucket_rows.items())},
                "bucket_padded_rows": {
                    str(k): v for k, v in sorted(self.bucket_padded.items())
                },
                "bucket_occupancy": {
                    str(k): round(
                        self.bucket_rows.get(k, 0)
                        / (self.bucket_rows.get(k, 0) + v),
                        4,
                    )
                    for k, v in sorted(self.bucket_padded.items())
                    if self.bucket_rows.get(k, 0) + v
                },
                "queue_ms": self.queue.snapshot(),
                "compute_ms": self.compute.snapshot(),
                "total_ms": self.total.snapshot(),
                "freshness_applied_ms": self.fresh_applied.snapshot(),
                "freshness_scored_ms": self.fresh_scored.snapshot(),
            }

    def log_to(self, sink) -> None:
        """Append the snapshot as a ``kind=serving`` record.  ``sink`` is
        a telemetry.RunMonitor (the engine's — records get the shared
        envelope) or, for bare callers, a utils.tracing.MetricsLogger
        (no-op logger ⇒ no-op here)."""
        snap = self.snapshot()
        emit = getattr(sink, "emit", None)
        if emit is not None:
            emit("serving", **snap)
        else:
            sink.log(kind="serving", **snap)
