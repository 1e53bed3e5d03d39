"""K train steps captured once into a CUDA graph and replayed — the port's
counterpart of the JAX package's ``lax.scan`` over K steps in one XLA
dispatch (``steps_per_call`` > 1).

``StepGraphs(fn)`` wraps ``fn(state, *inputs) -> (state, losses [K])``, a
plain loop over K step bodies.  Its first call for a (layout, state
tensors, input shapes) key:

1. copies the inputs into static device buffers;
2. warms ``fn`` up once on a side stream, so lazy set-up (kernel loads,
   autograd, the sort's scratch) happens outside the capture: on the live
   table and accumulator inside ``ops.tail.rows_restored`` (each row a tail
   is about to write is saved first and written back after, so the warm-up
   costs a copy of the rows the K batches touch, never a second state) and
   on clones of the dense leaves;
3. captures ``fn`` on the real state and the static buffers into a
   ``torch.cuda.CUDAGraph`` (a capture records and runs nothing), ending
   the captured region by ``copy_``-ing any state tensor ``fn`` replaced
   into the persistent one, so replay N+1 reads what replay N wrote.

Every call, the first included, then copies its inputs (host or device
tensors) into the static buffers and replays the graph: the K steps run as
one graph launch with no host work between them.  ``state.step`` stays a
host integer, advanced by K per replay.  The losses come back as a fresh
[K] tensor, never the graph's own output buffer.  On a CPU state a call is
``fn`` itself, the plain loop.

Launch counters: a kernel wrapper counts the launches it makes.  The
warm-up's are counted; the capture's are not (a capture records and
launches nothing); the kernels a replay runs never pass through a wrapper.
``replays`` counts the graph launches, ``captures`` the recordings (each
also counts as one compile for the telemetry's compile sentinel).
``last_inputs`` holds the buffers the last call's steps read (the graph's
static buffers on the card, the inputs themselves on the CPU), for a
caller that reads the batch after the call (the delta checkpoint's touched
rows).  A capture records in ``thread_local`` mode, so a checkpoint writer
thread working on its own stream does not invalidate it.
"""

from __future__ import annotations

import dataclasses

import torch

from fast_tffm_tpu_torch.ops.tail import rows_restored
from fast_tffm_tpu_torch.telemetry import note_compile

__all__ = ["StepGraphs"]


def _tensors(state) -> list:
    """The state's tensors in a fixed order (None where it has none)."""
    return [state.table, state.table_accum, *state.dense, *state.dense_accum]


def _set_tensors(state, tensors) -> None:
    nd = len(state.dense)
    state.table, state.table_accum = tensors[0], tensors[1]
    state.dense = list(tensors[2 : 2 + nd])
    state.dense_accum = list(tensors[2 + nd :])


def _warmup_view(state):
    """The live table and accumulator (the tails' rows are restored around
    the warm-up) with clones of the dense leaves (updated whole)."""
    return dataclasses.replace(
        state,
        dense=[p.clone() for p in state.dense],
        dense_accum=[a.clone() for a in state.dense_accum],
    )


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    inputs: list
    losses: torch.Tensor


class StepGraphs:
    """``fn(state, *inputs) -> (state, losses [K])``: on a CUDA state one
    CUDA-graph replay per call, on a CPU state ``fn`` (see the module
    docstring)."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs: dict[tuple, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self.last_inputs: tuple = ()

    def __call__(self, state, *inputs):
        if state.table.device.type != "cuda":
            self.last_inputs = inputs
            return self.fn(state, *inputs)
        key = (
            state.layout,
            tuple(None if t is None else t.data_ptr() for t in _tensors(state)),
            tuple((tuple(t.shape), t.dtype) for t in inputs),
        )
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(state, inputs)
        for static, t in zip(cap.inputs, inputs):
            static.copy_(t, non_blocking=True)
        cap.graph.replay()
        self.replays += 1
        self.last_inputs = tuple(cap.inputs)
        state.step += cap.losses.shape[0]
        return state, cap.losses.clone()

    def _capture(self, state, inputs) -> _Captured:
        device = state.table.device
        static = [torch.empty_like(t, device=device).copy_(t) for t in inputs]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side), rows_restored():
            self.fn(_warmup_view(state), *static)
        current.wait_stream(side)
        persistent, step = _tensors(state), state.step
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out, losses = self.fn(state, *static)
                for keep, new in zip(persistent, _tensors(out)):
                    if keep is not None and new is not keep:
                        keep.copy_(new)
        finally:
            _set_tensors(state, persistent)
            state.step = step
        self.captures += 1
        note_compile()
        return _Captured(graph, static, losses)
