"""The yardstick's arithmetic: the card's peaks, a step's least time for
``mfu``, and kernel B4's least time for its roofline.

A least time is the larger of the bytes the work cannot avoid over the
memory rate and the operations it needs over the compute rate at the
precision the configuration states.  Only what the algorithm must move or
compute is counted, never what an implementation materializes, so no
fusion can push a share past 100%.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peaks", "least_s", "step_bytes", "step_least_s", "tail_work",
           "tail_least_s"]

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "fp32": 67e12,
        "tf32": 495e12,
        "bf16": 989e12,
        "fp8": 1979e12,
    },
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peaks for {kind!r}; the table has {sorted(PEAKS)}")
    return PEAKS[kind]


def least_s(nbytes: float, flops: dict, pk: dict) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time of work moving
    ``nbytes`` and computing ``flops`` ({precision: count}, each at its own
    peak, one after another)."""
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    t_ops = sum(n / pk[p] for p, n in flops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def step_bytes(b: int, n: int, u: int, d: int, a: int, dense_numel: int) -> float:
    """A training step's irreducible bytes: the batch's ids and values
    (4 B each a slot), labels and weights (4 B each an example) read once;
    each of the U unique rows' D table and A accumulator floats read once
    and written once; each dense parameter and its accumulator read once
    and written once."""
    return 8.0 * b * n + 8.0 * b + 8.0 * u * (d + a) + 16.0 * dense_numel


def step_least_s(b: int, n: int, u: int, d: int, a: int, dense_numel: int, flops: dict,
                 pk: dict) -> tuple[float, str]:
    return least_s(step_bytes(b, n, u, d, a, dense_numel), flops, pk)


def tail_work(m: int, u: int, d: int, a: int) -> tuple[float, dict]:
    """Kernel B4's work, M sorted occurrences onto U unique rows: each
    occurrence's id (4 B) and gradient row (4·D B) read once, each unique
    row's table and accumulator floats read and written once; one add an
    occurrence element and about 6 operations a table element (g², add,
    lr·g, sqrt, divide, subtract).  ``chip_smoke.tail_bound`` without the
    sort's 8-byte index an occurrence, which is the port's choice and not
    the tail's work."""
    return m * (4.0 + 4.0 * d) + 8.0 * u * (d + a), {"fp32": float(m * d + 6 * u * d)}


def tail_least_s(m: int, u: int, d: int, a: int, pk: dict) -> tuple[float, str]:
    nbytes, flops = tail_work(m, u, d, a)
    return least_s(nbytes, flops, pk)
