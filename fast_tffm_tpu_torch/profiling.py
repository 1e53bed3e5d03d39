"""Step-window traces, the per-program cost ledger and id-traffic
statistics — the counterpart of ``fast_tffm_tpu/profiling.py``, emitting
through the ``telemetry.RunMonitor`` envelope.

  * ``StepProfiler`` — a ``torch.profiler`` trace (host and, on the card,
    device activity) over an exact step window (``[Telemetry]
    profile_steps = A:B`` / ``--profile-steps A:B``): it starts at the first
    call completing step >= A and stops at the first completing step >= B
    (K-step calls round to their boundaries), exported as a Chrome trace
    into ``<model_file>.profile`` (``trace_dir`` overrides); start and stop
    land as ``kind=profile`` records whose ``program`` is ``"trace"``.
  * ``CostLedger`` — one ``kind=profile`` record per distinct step program
    (``train_step``, each captured K-step graph, ``predict_step``) with the
    modeled HBM floor (``modeled_step_bytes``) and its examples.
    The JAX package fills ``flops`` and ``bytes_accessed`` from XLA's cost
    analysis; the port has no compiler cost model, so they are null (the
    schema allows it; tools/report.py renders "–"): no estimate goes under
    a measured name.
  * ``DataStatsCollector`` — every ``datastats_every_steps`` steps, the
    sampled call's ids on their own device: unique ids, the dedup ratio, a
    top-K heavy-hitter sketch over 2^12 buckets of the JAX package's Knuth
    hash (collisions only overstate a bucket, so the mass is an upper
    bound) and a cumulative rows-seen bitmap.  Padding slots (id 0) count:
    the gather reads them too.  Its integer statistics are the JAX
    collector's on the same batches.
"""

from __future__ import annotations

import time

import numpy as np

from fast_tffm_tpu_torch.utils import tracing

__all__ = [
    "parse_profile_steps",
    "StepProfiler",
    "CostLedger",
    "modeled_step_bytes",
    "DataStatsCollector",
]


def parse_profile_steps(spec: str) -> tuple[int, int] | None:
    """``"A:B"`` -> (A, B) with 0 <= A < B; ""/None -> None (disabled)."""
    if not spec:
        return None
    a, sep, b = str(spec).partition(":")
    try:
        if not sep:
            raise ValueError
        lo, hi = int(a), int(b)
        if lo < 0 or hi <= lo:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"profile_steps must be 'A:B' with 0 <= A < B, got {spec!r}"
        ) from None
    return lo, hi


class StepProfiler:
    """A bounded ``torch.profiler`` trace over a step window (see the module
    docstring).  ``on_step(step)`` runs once per completed call with the
    step counter after it: a few comparisons outside the window.  ``close()``
    stops a trace still open, so a window past the run's end still yields a
    trace.  ``cuda`` adds the card's activity.  A trace that cannot start
    (another profiler is open: they do not nest) is logged and skipped.
    Spans (``utils/tracing.spans_on``) are on from the call before the
    window, when the previous call's length says the next one opens it
    (so the instrumented graph is captured outside the trace), until the
    trace stops; the ``trace_stop`` record carries the counters' change
    over the window (``counters``)."""

    def __init__(self, spec: str, out_dir: str, *, monitor=None, log=None, cuda: bool = False):
        self._range = parse_profile_steps(spec)
        self._dir = out_dir
        self._monitor = monitor
        self._log = log
        self._cuda = cuda
        self._prof = None
        self._done = self._range is None
        self._t0 = 0.0
        self._last: int | None = None  # the step after the previous call
        self._spans = False  # this profiler turned spans on
        self._at_start: dict = {}
        self.path: str | None = None

    def _emit(self, step: int, event: str, **extra) -> None:
        if self._monitor is None:
            return
        try:
            self._monitor.emit(
                "profile", step=step, program="trace", flops=None,
                bytes_accessed=None, event=event, trace_dir=self._dir, **extra,
            )
        except (OSError, ValueError):
            pass  # a full metrics disk must not kill the trace

    def on_step(self, step: int) -> None:
        if self._done:
            return
        lo, hi = self._range
        last, self._last = self._last, step
        if self._prof is None and not self._spans and (
                step >= lo or (last is not None and 2 * step - last >= lo)):
            tracing.spans_on(True)
            self._spans = True
        if self._prof is None and step >= lo:
            import torch
            import torch.profiler

            self._at_start = tracing.counters()
            prof = torch.profiler.profile(activities=tracing._activities(self._cuda))
            try:
                prof.start()
            except RuntimeError as e:  # another profiler is open
                self._done = True
                self._spans_off()
                if self._log is not None:
                    self._log(f"profile trace failed to start: {e!r}")
                return
            if self._cuda:
                # Settle the card's tracing before the window's first launch
                # (one wait a window, never per step).
                torch.cuda.synchronize()
            self._prof = prof
            self._t0 = time.perf_counter()
            if self._log is not None:
                self._log(f"profiling: trace started at step {step} -> {self._dir} "
                          f"(stops at step >= {hi})")
            self._emit(step, "trace_start")
            # Never stop in the same call: a K-step call that spans the
            # whole window still captures one call.
            return
        if self._prof is not None and step >= hi:
            self._stop(step)

    def _stop(self, step: int) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        if self._cuda:
            import torch

            torch.cuda.synchronize()  # the window's last launches finish inside the trace
        prof.stop()
        counters = tracing.counter_delta(self._at_start)
        self._spans_off()
        dt = time.perf_counter() - self._t0
        lo, hi = self._range
        self.path = tracing.export_trace(prof, self._dir, f"profile_steps_{lo}_{hi}")
        if self._log is not None:
            self._log(f"profiling: trace stopped at step {step} ({dt:.2f}s captured) "
                      f"-> {self.path}")
        self._emit(step, "trace_stop", trace_s=round(dt, 3), trace_path=self.path,
                   counters=counters)

    def _spans_off(self) -> None:
        if self._spans:
            tracing.spans_on(False)
            self._spans = False

    def close(self, step: int = 0) -> None:
        if self._prof is not None:
            self._stop(step)
        self._spans_off()


# -- the cost ledger -------------------------------------------------------


def modeled_step_bytes(ids: np.ndarray, row_dim: int, accum_cols: int) -> tuple[int, int]:
    """Lower-bound HBM bytes of one order-2 sparse train step over host
    ``ids`` — the JAX function, term for term: ids read, forward gather,
    backward re-read, row-grad and segment-sum writes, the table's and the
    accumulator's read-modify-write over the unique rows (sort passes and
    temporaries excluded, so a floor).  Returns (modeled_bytes, unique_ids)."""
    ids = np.asarray(ids)
    m = int(ids.size)
    uniq = int(np.unique(ids).size)
    row = int(row_dim) * 4
    total = (
        m * 4  # ids read
        + m * row  # forward gather
        + m * row  # backward re-read
        + m * row  # row-grad write
        + m * row  # segment-sum write
        + 2 * uniq * row  # table RMW over unique rows
        + 2 * uniq * int(accum_cols) * 4  # accumulator RMW
    )
    return int(total), uniq


class CostLedger:
    """One ``kind=profile`` record per distinct step program.  ``stage``
    queues a program's record (examples, modeled floor, extra keys) and
    ``flush`` emits what is queued after a call completes; each name is
    recorded once per run.  ``flops`` and ``bytes_accessed`` are null: the
    port has no compiler cost analysis to measure them with."""

    def __init__(self, monitor):
        self._monitor = monitor
        self._pending: dict[str, dict] = {}
        self._done: set[str] = set()
        self.measured: dict[str, dict] = {}  # program -> emitted record body

    def want(self, name: str) -> bool:
        return name not in self._done and name not in self._pending

    def stage(self, name: str, *, examples: int | None = None,
              modeled_bytes: int | None = None, **meta) -> None:
        if not self.want(name):
            return
        self._pending[name] = dict(
            program=name, flops=None, bytes_accessed=None, transcendentals=None,
            examples=examples, bytes_per_example=None, modeled_hbm_bytes=modeled_bytes, **meta,
        )

    def flush(self, step: int = 0) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, {}
        for name, body in pending.items():
            self._done.add(name)
            self.measured[name] = body
            try:
                self._monitor.emit("profile", step=step, **body)
            except (OSError, ValueError):
                pass  # a full metrics disk must not kill the run

    def summary(self) -> dict:
        return {"profile_programs": len(self.measured)} if self.measured else {}


# -- id-traffic statistics -------------------------------------------------

_HH_BUCKETS = 1 << 12  # heavy-hitter sketch width (collisions overstate mass)
_HASH_MULT = 2654435761  # Knuth multiplicative hash (uint32)
_HASH_SHIFT = 32 - 12


class DataStatsCollector:
    """Sampled id-traffic statistics (see the module docstring).

    ``note(step, batch=b)`` after every call; at each ``every_steps``
    boundary it reduces that call's ids — ``ids_fn(batch)`` when given (the
    device cache: ids from the resident arrays), else ``batch.ids`` — on
    their own device and emits one ``kind=datastats`` record.  The bucket
    counts and the rows-seen bitmap accumulate across samples; unique and
    dedup are per call (the gather's own granularity).  A sample reads
    three numbers back to the host: one sync every ``every_steps`` steps."""

    def __init__(self, monitor, *, vocab: int, row_dim: int, every_steps: int,
                 heavy_hitter_k: int = 16, ids_fn=None):
        self._monitor = monitor
        self._vocab = int(vocab)
        self._row_bytes = int(row_dim) * 4
        self._every = int(every_steps)
        self._k = max(1, int(heavy_hitter_k))
        self._ids_fn = ids_fn
        self._last_step = None
        self._bitmap = None
        self._counts = np.zeros((_HH_BUCKETS,), np.int64)
        self.samples = 0
        self.ids_total = 0
        self.unique_total = 0
        self.rows_seen = 0

    def reduce(self, ids):
        """(unique, bucket counts [4096] int64 numpy, rows seen so far) of
        one sample, the bitmap updated — the JAX reducer's integers."""
        import torch

        flat = ids.reshape(-1).to(torch.int64)
        if self._bitmap is None or self._bitmap.device != flat.device:
            self._bitmap = torch.zeros(self._vocab, dtype=torch.bool, device=flat.device)
        s = torch.sort(flat).values
        uniq = 1 + (s[1:] != s[:-1]).sum()
        # The uint32 product mod 2^32 in int64, by 16-bit halves (no
        # overflow for any 32-bit id).
        lo, hi = flat & 0xFFFF, (flat >> 16) & 0xFFFF
        h32 = (lo * _HASH_MULT + (((hi * _HASH_MULT) & 0xFFFF) << 16)) & 0xFFFFFFFF
        h = h32 >> _HASH_SHIFT
        counts = torch.bincount(h, minlength=_HH_BUCKETS)
        self._bitmap.index_fill_(0, flat.clamp(0, self._vocab - 1), True)
        out = torch.stack([uniq, self._bitmap.sum()]).cpu()
        return int(out[0]), counts.cpu().numpy().astype(np.int64), int(out[1])

    def note(self, step: int, batch=None) -> None:
        if self._every <= 0:
            return
        if self._last_step is None:
            self._last_step = int(step)  # armed at the first call
            return
        if step - self._last_step < self._every:
            return
        window = int(step - self._last_step)
        self._last_step = int(step)
        ids = self._ids_fn(batch) if self._ids_fn is not None else getattr(batch, "ids", None)
        if ids is None:
            return
        uniq, counts, seen = self.reduce(ids)
        n = int(ids.numel())
        self._counts += counts
        self.samples += 1
        self.ids_total += n
        self.unique_total += uniq
        self.rows_seen = seen
        top = np.sort(self._counts)[::-1][: self._k]
        hh_mass = float(top.sum() / max(1, self._counts.sum()))
        try:
            self._monitor.emit(
                "datastats",
                step=step,
                window_steps=window,
                ids=n,
                unique=uniq,
                dedup_ratio=round(uniq / n, 4) if n else None,
                rows_seen=seen,
                rows_seen_frac=round(seen / self._vocab, 6) if self._vocab else None,
                hh_k=self._k,
                hh_topk_mass=round(hh_mass, 4),
                hh_top_counts=[int(x) for x in top[: min(self._k, 8)]],
                gather_bytes=n * self._row_bytes,
                dedup_gather_bytes=uniq * self._row_bytes,
                projected_gather_savings_frac=round(1.0 - uniq / n, 4) if n else None,
            )
        except (OSError, ValueError):
            pass  # a full metrics disk must not kill the run

    def summary(self) -> dict:
        if not self.samples:
            return {}
        top = np.sort(self._counts)[::-1][: self._k]
        return {
            "datastats_samples": self.samples,
            "datastats_dedup_ratio": round(self.unique_total / max(1, self.ids_total), 4),
            "datastats_rows_seen": self.rows_seen,
            "datastats_hh_topk_mass": round(float(top.sum() / max(1, self._counts.sum())), 4),
        }
