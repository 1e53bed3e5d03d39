"""Tiered admission queue: bounded FIFO with shed-by-class eviction.

The engine's admission queue is the ONLY elastic buffer between the
socket and the device, so overload policy lives here.  A plain bounded
queue degrades uniformly — the 100th free-tier request and the first
gold-tier request are rejected alike.  This queue degrades by PRIORITY:
when full, an arriving request may EVICT a queued request of a strictly
lower tier (the oldest of the lowest tier present), so overload sheds
the cheapest traffic first and gold requests only start failing once
nothing below them is left to shed.

FIFO within the bound (tier never reorders service — a queued gold
request behind ten std requests still waits its turn; tiers only decide
who gets SHED, not who gets served first, which keeps latency fair and
the shed policy orthogonal).  queue.Full / queue.Empty are reused so
callers keep stdlib-queue idioms.  Thread-safe.

A copy of ``fast_tffm_tpu/serving/admission.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Bounded FIFO of (tier, item) with lowest-tier-first eviction.

    ``put_nowait``/``put`` return the EVICTED item (or None) instead of
    silently dropping it — the caller owns failing its future with a
    typed Overloaded error and counting the shed.
    """

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._d: deque = deque()  # entries: (tier, item); sentinel tier None

    def qsize(self) -> int:
        with self._lock:
            return len(self._d)

    def oldest_wait_s(self, now: float | None = None) -> float | None:
        """Age of the oldest queued item carrying a ``t_submit`` attr —
        the health probe a router uses to spot a wedged collector (the
        queue keeps aging when nothing downstream drains it)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            for _, item in self._d:
                t = getattr(item, "t_submit", None)
                if t is not None:
                    return now - t
        return None

    # -- producers ---------------------------------------------------------

    def _try_admit(self, item, tier: int):
        """Lock held.  Returns (admitted, evicted)."""
        if len(self._d) < self.maxsize:
            self._d.append((tier, item))
            self._not_empty.notify()
            return True, None
        # Full: shed the OLDEST entry of the LOWEST tier strictly below
        # the arrival's.  Oldest-of-lowest is deterministic and sheds the
        # entry most likely to be stale by the time it would flush.
        victim_i = victim_tier = None
        for i, (t, entry) in enumerate(self._d):
            if t is None or t >= tier:  # sentinel / not strictly lower
                continue
            if victim_tier is None or t < victim_tier:
                victim_i, victim_tier = i, t
        if victim_i is None:
            return False, None
        victim = self._d[victim_i][1]
        del self._d[victim_i]
        self._d.append((tier, item))
        self._not_empty.notify()
        return True, victim

    def put_nowait(self, item, tier: int = 0):
        """Admit or raise queue.Full; returns the evicted item or None."""
        with self._lock:
            admitted, evicted = self._try_admit(item, tier)
            if not admitted:
                raise queue.Full
            return evicted

    def put(self, item, tier: int = 0, timeout: float | None = None):
        """Blocking admit (backpressure policy); still evicts a strictly
        lower tier rather than waiting — a gold request must not block
        behind shed-able free traffic.  Raises queue.Full on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                admitted, evicted = self._try_admit(item, tier)
                if admitted:
                    return evicted
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise queue.Full
                self._not_full.wait(wait)

    def put_sentinel(self, obj) -> None:
        """Enqueue a control object (e.g. a close sentinel) UNCONDITIONALLY
        — it bypasses the bound (by at most one entry) and can never be
        evicted, so shutdown cannot be starved by a full queue."""
        with self._lock:
            self._d.append((None, obj))
            self._not_empty.notify()

    # -- the consumer (collector thread) -----------------------------------

    def get(self, timeout: float | None = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not self._d:
                wait = None if deadline is None else deadline - time.monotonic()
                if wait is not None and wait <= 0:
                    raise queue.Empty
                self._not_empty.wait(wait)
            _, item = self._d.popleft()
            self._not_full.notify()
            return item

    def get_nowait(self):
        with self._lock:
            if not self._d:
                raise queue.Empty
            _, item = self._d.popleft()
            self._not_full.notify()
            return item
