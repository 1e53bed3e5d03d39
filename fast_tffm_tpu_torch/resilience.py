"""Fault handling shared by the port's supervisors.

So far one piece of ``fast_tffm_tpu/resilience.py``: ``RestartPolicy``,
which the serving router (``serving/router.py``) applies to replica
restarts.  Rollback on a non-finite loss, the training supervisor and
fault injection are not ported yet.
"""

from __future__ import annotations

__all__ = ["RestartPolicy"]


class RestartPolicy:
    """Bounded retries + exponential backoff, as data: ``backoff(attempt)``
    returns the pre-relaunch sleep for restart ``attempt`` (1-based), or
    None once the budget is spent (``[Resilience] restart_max``,
    ``restart_backoff_s``, ``restart_backoff_max_s``)."""

    def __init__(self, max_restarts: int, backoff_s: float, backoff_max_s: float):
        self.max_restarts = max(0, int(max_restarts))
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)

    def backoff(self, attempt: int) -> float | None:
        if attempt > self.max_restarts:
            return None
        return min(self.backoff_s * (2.0 ** (attempt - 1)), self.backoff_max_s)
