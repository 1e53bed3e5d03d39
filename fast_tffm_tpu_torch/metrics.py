"""Evaluation metrics and throughput accounting — the port's own copy of
``fast_tffm_tpu/metrics.py`` (numpy only; the port imports nothing of the
JAX package).

Exact rank-based AUC, a bounded-memory self-healing streaming AUC for
validation splits that don't fit host RAM, and a small examples/sec meter
for the train loop.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

__all__ = ["auc", "StreamingAUC", "Throughput"]


def auc(labels: np.ndarray, scores: np.ndarray, weights: np.ndarray | None = None) -> float:
    """Exact ROC AUC via the rank statistic (ties get average rank)."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    if weights is not None:
        keep = np.asarray(weights) > 0
        labels, scores = labels[keep], scores[keep]
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    if np.isnan(scores).any():
        # Ranking NaNs (argsort puts them last) would fabricate a finite
        # AUC from poisoned scores (e.g. an alltoall-lookup capacity
        # overflow or a diverged model).  Surface nan instead.
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(scores)
    ranks[order] = np.arange(1, scores.size + 1, dtype=np.float64)
    # Average ranks over tied scores.
    sorted_scores = scores[order]
    i = 0
    while i < sorted_scores.size:
        j = i
        while j + 1 < sorted_scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


class StreamingAUC:
    """Bounded-memory streaming ROC AUC (exact below a cap, binned above,
    SELF-HEALING when the bins degrade).

    Exact AUC (above) materializes every score to sort it — impossible for
    a Criteo-scale validation split.  This accumulator is exact until
    ``exact_cap`` rows have been seen (it just buffers them), then spills
    to a histogram whose bucket edges are the QUANTILES of the buffered
    sample — equal-mass buckets wherever the score distribution actually
    lives.  After the spill, same-bucket cross-class pairs count as ties;
    on a prefix representative of the stream that sits well inside 1e-4
    of exact (test-pinned).

    The accuracy claim is SELF-CHECKING and the degraded case SELF-HEALS:

    * per-bucket score min/max are tracked after the spill, so
      ``error_bound()`` knows how much cross-class mass shares a bucket
      with a genuine score spread (real ties — identical scores — cost
      nothing: exact AUC half-weights them too);
    * a bounded uniform RESERVOIR of (label, score) samples rides along
      the whole stream;
    * ``add`` processes data in sub-chunks and checks, BEFORE committing
      each sub-chunk, what the bound would become.  If it would exceed
      ``warn_above`` (e.g. the spill prefix under-represented the stream
      and the quantile edges can't resolve incoming scores), the
      accumulator RE-BINS first: fresh quantile edges from the reservoir
      plus the pending sub-chunk, growing up to ``max_bins`` buckets.
      Buckets holding a single score value relocate exactly; buckets
      already holding spread mass become SPAN ENTRIES (lo, hi, pos, neg)
      whose residual ambiguity ``error_bound()`` keeps counting against
      all mass inside their span — healing never launders past
      uncertainty, it only stops new mass from joining it.
    * ``value()`` warns only if the bound is STILL above ``warn_above``
      after any healing — i.e. when the data genuinely exceeds the
      configured resolution (tiny ``max_bins``, or a stream that ended
      right at the spill).

    Memory: O(exact_cap + max_bins) — ~15 MB at the defaults —
    regardless of stream length.  Deterministic: the reservoir RNG is
    fixed-seeded, so the same stream always yields the same estimate.
    Matches ``auc``'s contract: weight-0 rows drop (batch padding), any
    NaN score poisons the result to nan, and a single-class stream is
    nan.
    """

    _CHUNK = 8192  # sub-chunk size for pre-commit degradation checks
    _MAX_ENTRIES = 1024  # span-entry cap; adjacent entries merge beyond it

    def __init__(
        self, bins: int = 1 << 16, exact_cap: int = 1 << 20,
        warn_above: float = 1e-4, max_bins: int | None = None,
    ):
        if bins < 2:
            raise ValueError(f"bins must be >= 2, got {bins}")
        self._bins = bins
        self._max_bins = max(bins, 1 << 16) if max_bins is None else max(bins, max_bins)
        self._cap = max(int(exact_cap), bins)
        self._warn_above = warn_above
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []  # (labels, scores)
        self._buffered = 0
        self._edges = None  # set at spill; histogram mode from then on
        # float64 counts: integer-exact far past any real row count, and
        # float keeps the epilogue's dot products simple.
        self._pos = np.zeros(bins, np.float64)
        self._neg = np.zeros(bins, np.float64)
        # Per-bucket observed score range (post-spill): a bucket whose
        # min == max holds only REAL ties, which cost no accuracy.
        self._lo = np.full(bins, np.inf)
        self._hi = np.full(bins, -np.inf)
        # Span entries: committed mass whose location is only known to an
        # interval (created by healing from already-mixed buckets).
        self._e_lo = np.empty(0, np.float64)
        self._e_hi = np.empty(0, np.float64)
        self._e_pos = np.empty(0, np.float64)
        self._e_neg = np.empty(0, np.float64)
        self._entry_cache = None  # recomputed when entries or edges change
        # Reservoir (post-spill): uniform sample of the stream for re-edging.
        self._res_labels = np.empty(0, np.float32)
        self._res_scores = np.empty(0, np.float64)
        self._res_seen = 0
        # After a heal that fails to bring the bound under warn_above,
        # don't retry every sub-chunk — wait until the reservoir has seen
        # substantially more of the stream.
        self._heal_block_until = 0
        self._rng = np.random.default_rng(0)
        self._nan_seen = False

    def add(
        self,
        labels: np.ndarray,
        scores: np.ndarray,
        weights: np.ndarray | None = None,
    ) -> None:
        labels = np.asarray(labels)
        scores = np.asarray(scores, np.float64)
        if weights is not None:
            keep = np.asarray(weights) > 0
            labels, scores = labels[keep], scores[keep]
        if scores.size == 0:
            return
        if np.isnan(scores).any():
            self._nan_seen = True
            return
        if self._edges is None:
            self._chunks.append((labels.astype(np.float32), scores))
            self._buffered += scores.size
            if self._buffered > self._cap:
                self._spill()
            return
        for i in range(0, scores.size, self._CHUNK):
            c_lab = labels[i : i + self._CHUNK]
            c_sco = scores[i : i + self._CHUNK]
            if (
                self._warn_above is not None  # None: no warn, no heal
                and self._res_seen >= self._heal_block_until
                and self._would_degrade(c_lab, c_sco)
            ):
                self._heal(c_sco)
                if self._would_degrade(c_lab, c_sco):
                    # Even fresh edges can't resolve this chunk — the
                    # resolution budget (max_bins / reservoir content) is
                    # exhausted.  Don't burn a futile heal per chunk;
                    # retry once the stream (hence the reservoir) doubles.
                    self._heal_block_until = max(2 * self._res_seen, 1)
            self._count(c_lab, c_sco)
            self._reservoir_add(c_lab, c_sco)

    # -- spill -----------------------------------------------------------

    def _spill(self) -> None:
        """Pick quantile bucket edges from the buffered sample, fold the
        buffer into the histogram, and seed the reservoir from it."""
        labels = np.concatenate([c[0] for c in self._chunks])
        scores = np.concatenate([c[1] for c in self._chunks])
        self._chunks.clear()
        self._buffered = 0
        qs = np.quantile(scores, np.linspace(0.0, 1.0, self._bins + 1)[1:-1])
        # Duplicate edges (massive score ties) collapse into one bucket —
        # identical scores are ties either way.
        self._set_edges(np.unique(qs))
        self._count(labels, scores)
        self._reservoir_add(labels, scores)

    def _set_edges(self, edges: np.ndarray) -> None:
        self._edges = edges
        n = edges.size + 1
        self._pos = np.zeros(n, np.float64)
        self._neg = np.zeros(n, np.float64)
        self._lo = np.full(n, np.inf)
        self._hi = np.full(n, -np.inf)
        self._entry_cache = None

    def _count(self, labels, scores) -> None:
        idx = np.searchsorted(self._edges, scores, side="right")
        pos = np.asarray(labels) > 0.5
        self._pos += np.bincount(idx[pos], minlength=self._pos.size)
        self._neg += np.bincount(idx[~pos], minlength=self._neg.size)
        np.minimum.at(self._lo, idx, scores)
        np.maximum.at(self._hi, idx, scores)

    # -- reservoir -------------------------------------------------------

    def _reservoir_add(self, labels, scores) -> None:
        """Uniform-ish sample over the whole post-spill stream (vectorized
        algorithm-R: per-item acceptance at cap/seen, random slot on
        accept).  Representativeness is not load-bearing — the bound
        self-checks — it only steers where healing puts new edges."""
        cap = self._max_bins
        labels = np.asarray(labels, np.float32)
        free = cap - self._res_scores.size
        if free > 0:
            take = min(free, scores.size)
            self._res_labels = np.concatenate([self._res_labels, labels[:take]])
            self._res_scores = np.concatenate([self._res_scores, scores[:take]])
            self._res_seen += take
            labels, scores = labels[take:], scores[take:]
            if scores.size == 0:
                return
        seen = self._res_seen + np.arange(1, scores.size + 1)
        accept = self._rng.random(scores.size) < cap / seen
        n_acc = int(accept.sum())
        if n_acc:
            slots = self._rng.integers(0, cap, size=n_acc)
            self._res_labels[slots] = labels[accept]
            self._res_scores[slots] = scores[accept]
        self._res_seen += scores.size

    # -- healing ---------------------------------------------------------

    def _would_degrade(self, labels, scores) -> bool:
        """Would committing this sub-chunk push the FINE part of the bound
        past warn_above?  Only the fine (bucket) ambiguity counts here:
        span-entry debt is frozen history that re-binning cannot reduce —
        healing on it would just convert more fine mass into more entries
        (measured: it inflated the bound 30× on a benign stream)."""
        idx = np.searchsorted(self._edges, scores, side="right")
        pos = np.asarray(labels) > 0.5
        p2 = self._pos + np.bincount(idx[pos], minlength=self._pos.size)
        n2 = self._neg + np.bincount(idx[~pos], minlength=self._neg.size)
        lo2 = self._lo.copy()
        hi2 = self._hi.copy()
        np.minimum.at(lo2, idx, scores)
        np.maximum.at(hi2, idx, scores)
        n_pos = p2.sum() + self._e_pos.sum()
        n_neg = n2.sum() + self._e_neg.sum()
        if n_pos == 0 or n_neg == 0:
            return False
        mixed = hi2 > lo2
        fine = 0.5 * float((p2 * mixed) @ (n2 * mixed)) / float(n_pos * n_neg)
        return fine > self._warn_above

    def _heal(self, pending: np.ndarray) -> None:
        """Re-quantile the edges from reservoir + pending scores and
        rebuild the histogram.  Pure buckets (one score value) relocate
        exactly; mixed buckets become span entries that stay in the error
        accounting forever."""
        sample = np.concatenate([self._res_scores, pending])
        target = int(min(self._max_bins, sample.size))
        if target < 2:
            return
        qs = np.quantile(sample, np.linspace(0.0, 1.0, target + 1)[1:-1])
        new_edges = np.unique(qs)
        if new_edges.size == 0:
            return
        mass = (self._pos + self._neg) > 0
        pure = mass & (self._hi <= self._lo)
        mixed = mass & ~pure
        relocated = (self._pos[pure], self._neg[pure], self._lo[pure])
        self._e_lo = np.concatenate([self._e_lo, self._lo[mixed]])
        self._e_hi = np.concatenate([self._e_hi, self._hi[mixed]])
        self._e_pos = np.concatenate([self._e_pos, self._pos[mixed]])
        self._e_neg = np.concatenate([self._e_neg, self._neg[mixed]])
        self._compact_entries()
        self._set_edges(new_edges)
        p, n, v = relocated
        if v.size:
            idx = np.searchsorted(self._edges, v, side="right")
            np.add.at(self._pos, idx, p)
            np.add.at(self._neg, idx, n)
            np.minimum.at(self._lo, idx, v)
            np.maximum.at(self._hi, idx, v)

    def _compact_entries(self) -> None:
        """Merge adjacent span entries (union span, summed mass — strictly
        conservative) to hold the cap."""
        while self._e_lo.size > self._MAX_ENTRIES:
            order = np.argsort(self._e_lo, kind="mergesort")
            lo, hi = self._e_lo[order], self._e_hi[order]
            p, n = self._e_pos[order], self._e_neg[order]
            if lo.size % 2:  # keep the last entry unmerged on odd counts
                tail = (lo[-1:], hi[-1:], p[-1:], n[-1:])
                lo, hi, p, n = lo[:-1], hi[:-1], p[:-1], n[:-1]
            else:
                tail = None
            lo = lo[0::2]
            hi = np.maximum(hi[0::2], hi[1::2])
            p = p[0::2] + p[1::2]
            n = n[0::2] + n[1::2]
            if tail is not None:
                lo = np.concatenate([lo, tail[0]])
                hi = np.concatenate([hi, tail[1]])
                p = np.concatenate([p, tail[2]])
                n = np.concatenate([n, tail[3]])
            self._e_lo, self._e_hi, self._e_pos, self._e_neg = lo, hi, p, n
        self._entry_cache = None

    # -- estimates -------------------------------------------------------

    def _entries(self):
        """Edge- and entry-dependent terms, cached between heals:
        (blo, bhi) bucket spans per entry, overlap-weighted opposite-class
        entry mass, strictly-above entry wins."""
        if self._entry_cache is None:
            blo = np.searchsorted(self._edges, self._e_lo, side="right")
            bhi = np.searchsorted(self._edges, self._e_hi, side="right")
            lo, hi = self._e_lo, self._e_hi
            above = lo[:, None] > hi[None, :]  # entry i strictly above entry j
            ov = ~above & ~above.T  # overlapping (incl. self)
            self._entry_cache = (
                blo,
                bhi,
                ov @ self._e_pos,
                ov @ self._e_neg,
                above @ self._e_neg,
                float(self._e_pos @ (ov @ self._e_neg)),
            )
        return self._entry_cache

    def _bound_given(self, pos, neg, lo, hi) -> float:
        n_pos = pos.sum() + self._e_pos.sum()
        n_neg = neg.sum() + self._e_neg.sum()
        if n_pos == 0 or n_neg == 0:
            return 0.0
        mixed = hi > lo
        ambiguous = float((pos * mixed) @ (neg * mixed))
        if self._e_lo.size:
            blo, bhi, ov_pos, ov_neg, _, _ = self._entries()
            cpos = np.concatenate([[0.0], np.cumsum(pos)])
            cneg = np.concatenate([[0.0], np.cumsum(neg)])
            pos_span = cpos[bhi + 1] - cpos[blo] + ov_pos
            neg_span = cneg[bhi + 1] - cneg[blo] + ov_neg
            # Entry-vs-entry pairs appear in both entries' span terms —
            # counted twice, which only makes the bound more conservative.
            ambiguous += float(self._e_pos @ neg_span + self._e_neg @ pos_span)
        return 0.5 * ambiguous / float(n_pos * n_neg)

    def error_bound(self) -> float:
        """Worst-case |streaming − exact| given what has been seen: half
        the cross-class pair mass sharing a bucket (or a span entry's
        interval) with a real score spread; same-value ties are exact."""
        if self._edges is None:
            return 0.0
        return self._bound_given(self._pos, self._neg, self._lo, self._hi)

    def value(self) -> float:
        if self._nan_seen:
            return float("nan")
        if self._edges is None:
            if not self._chunks:
                return float("nan")
            return auc(
                np.concatenate([c[0] for c in self._chunks]),
                np.concatenate([c[1] for c in self._chunks]),
            )
        n_pos = self._pos.sum() + self._e_pos.sum()
        n_neg = self._neg.sum() + self._e_neg.sum()
        if n_pos == 0 or n_neg == 0:
            return float("nan")
        bound = self.error_bound()
        if self._warn_above is not None and bound > self._warn_above:
            import warnings

            warnings.warn(
                f"streaming AUC error bound {bound:.2e} exceeds "
                f"{self._warn_above:.0e} even after re-binning: the stream "
                "outran the configured resolution (raise max_bins / "
                "exact_cap, or shuffle the validation input)",
                RuntimeWarning,
                stacklevel=2,
            )
        # P(score_pos > score_neg) + 0.5 P(tie), bucket-wise: negatives in
        # strictly lower buckets count 1, same-bucket negatives count 0.5.
        neg_below = np.cumsum(self._neg) - self._neg
        wins = float(self._pos @ neg_below)
        ties = float(self._pos @ self._neg)
        if self._e_lo.size:
            # Span entries tie with everything inside their interval, win
            # against fine mass strictly below it, lose above — the same
            # half-weight convention the bound accounts for.
            blo, bhi, ov_pos, ov_neg, above_neg, ov_cross = self._entries()
            cpos = np.concatenate([[0.0], np.cumsum(self._pos)])
            cneg = np.concatenate([[0.0], np.cumsum(self._neg)])
            wins += float(self._e_pos @ cneg[blo])  # fine negs fully below
            wins += float(self._e_neg @ (cpos[-1] - cpos[bhi + 1]))  # fine pos above
            wins += float(self._e_pos @ above_neg)  # entries strictly above
            # Entry-fine in-span ties + entry-entry overlap ties (the ov
            # cross term, counted exactly once).
            ties += float(self._e_pos @ (cneg[bhi + 1] - cneg[blo]))
            ties += float(self._e_neg @ (cpos[bhi + 1] - cpos[blo]))
            ties += ov_cross
        return (wins + 0.5 * ties) / float(n_pos * n_neg)


class Throughput:
    """Examples/sec meter over a sliding window of recent steps.

    The original meter was cumulative-since-reset while its docstring
    claimed a sliding window: minutes after the last reset, a sudden
    slowdown averaged into invisibility.  This one keeps a deque of
    ``(t, n)`` step samples and reports the rate over the trailing
    ``window_s`` seconds — the ``examples_per_sec`` telemetry field
    tracks CURRENT throughput even when a driver stops resetting.

    ``rate()`` divides the in-window example count by the window span
    measured from ``max(last reset, now - window_s)`` — so shortly after
    a reset it behaves exactly like the old meter (the drivers reset at
    every log point), and only long unreset stretches change behavior.
    ``clock`` is injectable for deterministic tests.  Memory is bounded:
    past ``max_samples`` the two oldest samples merge (their step
    boundary blurs; totals stay exact).
    """

    def __init__(
        self, window_s: float = 60.0, max_samples: int = 8192, clock=time.perf_counter
    ):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self._window_s = float(window_s)
        self._max_samples = max(2, int(max_samples))
        self._clock = clock
        self._samples: deque[tuple[float, int]] = deque()
        self._in_window = 0
        self._t0 = clock()  # window anchor: max(reset time, pruned cutoff)

    def add(self, n: int):
        self._samples.append((self._clock(), n))
        self._in_window += n
        if len(self._samples) > self._max_samples:
            (t1, n1), (_, n2) = self._samples.popleft(), self._samples.popleft()
            self._samples.appendleft((t1, n1 + n2))

    def _prune(self, now: float) -> None:
        cutoff = now - self._window_s
        while self._samples and self._samples[0][0] < cutoff:
            _, n = self._samples.popleft()
            self._in_window -= n
        if cutoff > self._t0:
            self._t0 = cutoff

    def rate(self) -> float:
        now = self._clock()
        self._prune(now)
        dt = now - self._t0
        return self._in_window / dt if dt > 0 else 0.0

    def reset(self):
        self._samples.clear()
        self._in_window = 0
        self._t0 = self._clock()
