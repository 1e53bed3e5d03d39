"""Background prefetch — the counterpart of ``fast_tffm_tpu/utils/prefetch.py``.

``prefetch(it, depth)`` runs an iterator in a daemon thread with a bounded
queue, so host parsing of the next batches overlaps the card's step.
``grouped_pairs(pairs, k)`` groups a ``(parsed, weights)`` stream into
K-long lists for ``steps_per_call``.  Threading only.
"""

from __future__ import annotations

import itertools
import queue
import threading
from collections.abc import Iterable, Iterator

__all__ = ["prefetch", "PrefetchError", "grouped_pairs"]

_SENTINEL = object()


class PrefetchError(RuntimeError):
    """The prefetch producer thread failed (or died without signaling);
    the original exception rides as ``__cause__``."""


def grouped_pairs(pairs: Iterable, k: int) -> Iterator[tuple[list, list]]:
    """``(parsed, weights)`` pairs → ``([parsed]*k, [w]*k)`` lists, the last
    group shorter when the stream ends mid-group (the steps_per_call
    grouping rule)."""
    it = iter(pairs)
    while items := list(itertools.islice(it, k)):
        yield [p for p, _ in items], [w for _, w in items]


def prefetch(it: Iterable, depth: int = 8) -> Iterator:
    """Iterate ``it`` in a background thread, keeping ``depth`` items ready.

    A producer exception surfaces in the consumer as a ``PrefetchError``.
    The consumer polls with a timeout, so a producer that dies without
    reaching its sentinel is detected within ~1 s instead of blocking
    forever."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, name="input-prefetch", daemon=True)
    t.start()

    def fail(reason: str) -> PrefetchError:
        e = PrefetchError(f"input pipeline failed: prefetch producer thread {t.name!r} {reason}")
        e.__cause__ = err[0] if err else None
        return e

    while True:
        try:
            item = q.get(timeout=1.0)
        except queue.Empty:
            if not t.is_alive() and q.empty():
                raise fail(f"raised {err[0]!r}" if err else "died without signaling")
            continue
        if item is _SENTINEL:
            if err:
                raise fail(f"raised {err[0]!r}")
            return
        yield item
