"""What a metric's reader (``benchmark/metrics/<name>.py``, a function
``read(r)`` returning a number, or None where it finds nothing to read)
is handed.  End-to-end metrics read a ``WindowReading`` of the untraced
run; per-layer metrics a ``LayerReading`` of the traced stretch."""

from __future__ import annotations

import dataclasses

from benchmark import devtrace

__all__ = ["WindowReading", "LayerReading"]


@dataclasses.dataclass
class WindowReading:
    setup_s: float  # process start to the end of the warm-up
    window_s: float  # the window's wall time, first call to the closing sync
    calls: int  # K-step calls issued in the window
    steps: int  # training steps they ran
    examples: int  # examples they trained on


@dataclasses.dataclass
class LayerReading:
    trace: devtrace.Trace  # the traced stretch
    kernels: dict  # kernels.json's groups: name -> patterns
    steps: int  # training steps in the stretch
    batch_size: int
    n_fields: int
    unique_per_step: list  # each traced step's distinct ids
    row_dim: int  # D
    accum_width: int  # A: D (element accumulator) or 1 (row)
    dense_numel: int  # dense parameters
    flops_per_step: dict  # the model's operations a step, by precision
    peaks: dict  # roofline.peaks(the card)

    @property
    def window_s(self) -> float:
        return self.trace.window_s

    @property
    def busy_s(self) -> float:
        return devtrace.busy_s(self.trace)

    def group_s(self, *groups: str) -> float:
        """Device seconds of the kernels of ``groups`` (kernels.json)."""
        pats = [p for g in groups for p in self.kernels[g]]
        return devtrace.group_seconds(self.trace, pats)
