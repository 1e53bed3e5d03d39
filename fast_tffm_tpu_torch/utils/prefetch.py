"""Background prefetch — the counterpart of ``fast_tffm_tpu/utils/prefetch.py``.

``prefetch(it, depth)`` runs an iterator in a daemon thread with a bounded
queue, so host parsing of the next batches overlaps the card's step.
``grouped_pairs(pairs, k)`` groups a ``(parsed, weights)`` stream into
K-long lists for ``steps_per_call``.  ``InputStats`` times the producer and
samples the queue for ``kind=input`` records, and ``InputStream`` carries
a stream with its stats and the live probes the stall watchdog reads
(``queue_depth``, ``producer_alive``, and for a followed FMS stream
``stream_idle``).  Threading only.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections.abc import Iterable, Iterator

__all__ = ["prefetch", "PrefetchError", "grouped_pairs", "InputStats", "InputStream"]

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


class InputStats:
    """Per-stream input accounting (the JAX package's ``data/wire.py``
    ``InputStats``, without the wire): production time in the prefetch
    thread and the queue depth at each consumer pop, drained into a
    ``kind=input`` record at every log point.  The port converts batches in
    the consumer, so ``h2d_ms`` and ``wire_bytes_per_step`` are None (not
    measured here), as the JAX package writes them for text input."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue = None  # bound by prefetch(): the live-depth probe
        self._producer = None  # bound by prefetch(): the liveness probe
        self._stream_idle = None  # bound by follow streams: the idle probe
        self.last_depth = None
        self._reset()

    def _reset(self) -> None:
        self.items = 0  # queue items (a K-group is one)
        self.steps = 0  # batches covered
        self.examples = 0
        self.parse_s = 0.0
        self.q_depth_sum = 0
        self.q_samples = 0

    def bind_queue(self, q) -> None:
        self._queue = q

    def bind_producer(self, thread) -> None:
        self._producer = thread

    def bind_stream_idle(self, event) -> None:
        """A followed FMS stream (``data/stream.py``) hands over its idle
        Event, so a starved loop can classify as input-starved
        (stream-idle): the producer is alive and the writer quiet."""
        self._stream_idle = event

    def stream_idle(self) -> bool | None:
        e = self._stream_idle
        return e.is_set() if e is not None else None

    def queue_depth(self) -> int | None:
        q = self._queue
        return int(q.qsize()) if q is not None else self.last_depth

    def producer_alive(self) -> bool | None:
        t = self._producer
        return t.is_alive() if t is not None else None

    def timed(self, raw: Iterable) -> Iterator:
        """Wrap a ``(parsed, weights)`` stream (``parsed`` a ParsedBatch or a
        K-list of them), timing each item's production."""
        t0 = time.perf_counter()
        for p, w in raw:
            t1 = time.perf_counter()
            group = p if isinstance(p, list) else [p]
            with self._lock:
                self.items += 1
                self.steps += len(group)
                self.examples += sum(q.batch_size for q in group)
                self.parse_s += t1 - t0
            yield p, w
            t0 = time.perf_counter()

    def on_queue_depth(self, depth: int) -> None:
        with self._lock:
            self.last_depth = depth
            self.q_depth_sum += depth
            self.q_samples += 1

    def drain(self) -> dict:
        """Snapshot and reset; {} when nothing flowed since the last drain."""
        with self._lock:
            if not self.items:
                return {}
            out = {
                "input_items": self.items,
                "input_steps": self.steps,
                "input_examples": self.examples,
                "parse_ms": round(1e3 * self.parse_s / self.items, 3),
                "h2d_ms": None,
                "wire_bytes_per_step": None,
                "prefetch_queue_depth": (
                    round(self.q_depth_sum / self.q_samples, 2) if self.q_samples else None
                ),
            }
            self._reset()
        return out


class InputStream:
    """An input iterator with its ``InputStats``: the training loop iterates it,
    drains ``.stats`` into kind=input records and hands ``queue_depth``,
    ``producer_alive`` and ``stream_idle`` to the stall watchdog (readable
    while the consumer is frozen)."""

    def __init__(self, it: Iterable, stats: InputStats | None):
        self._it = it
        self.stats = stats

    def __iter__(self) -> Iterator:
        return iter(self._it)

    def queue_depth(self) -> int | None:
        return self.stats.queue_depth() if self.stats is not None else None

    def producer_alive(self) -> bool | None:
        return self.stats.producer_alive() if self.stats is not None else None

    def stream_idle(self) -> bool | None:
        return self.stats.stream_idle() if self.stats is not None else None


def prefetch(it: Iterable, depth: int = 8, stats: InputStats | None = None) -> Iterator:
    """Iterate ``it`` in a background thread, keeping ``depth`` items ready.

    A producer exception surfaces in the consumer as a ``PrefetchError``.
    The consumer polls with a timeout, so a producer that dies without
    reaching its sentinel is detected within ~1 s instead of blocking
    forever.  ``stats`` gets the queue and the producer thread bound (the
    watchdog's probes) and one depth sample per consumer pop."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    err: list[BaseException] = []
    if stats is not None:
        stats.bind_queue(q)

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, name="input-prefetch", daemon=True)
    if stats is not None:
        stats.bind_producer(t)
    t.start()

    def fail(reason: str) -> PrefetchError:
        e = PrefetchError(f"input pipeline failed: prefetch producer thread {t.name!r} {reason}")
        e.__cause__ = err[0] if err else None
        return e

    need_sample = True
    while True:
        if stats is not None and need_sample:
            # One depth sample per pop, not per 1 s retry (a slow producer
            # would flood the average with zeros).
            stats.on_queue_depth(q.qsize())
            need_sample = False
        try:
            item = q.get(timeout=1.0)
        except queue.Empty:
            if not t.is_alive() and q.empty():
                raise fail(f"raised {err[0]!r}" if err else "died without signaling")
            continue
        need_sample = True
        if item is _SENTINEL:
            if err:
                raise fail(f"raised {err[0]!r}")
            return
        yield item
