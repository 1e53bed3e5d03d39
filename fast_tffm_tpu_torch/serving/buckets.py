"""Bucket ladder: a fixed set of flush shapes, every flush padded up to one.

The counterpart of ``fast_tffm_tpu/serving/buckets.py``.  In the JAX
package the ladder bounds XLA compiles; PyTorch runs eagerly, so here it
bounds the set of shapes the kernels and allocator see, and keeps every
flush at a shape the warmup pass already ran (the kernel library is built
and loaded there, before traffic).  There is no jit cache, so the JAX
ladder's ``compile_count`` has no counterpart and is left out.

Padding rows are all-zero with weight 0: they score as sigmoid(0) and the
engine slices them off — the neutral-padding contract of the offline path.

Staging: a flush's arrays are written straight into ONE host buffer of
4-byte words (pinned when the device is a GPU) and cross to the device in
one copy, then are unpacked as views:

    [ labels B f32 | weights B f32 | ids B·N i32 | vals B·N f32 | fields B·F i32 ]

with F = N when the model reads fields, else 0.  The JAX package's packed
wire (``data/wire.py``) narrows these further; it changes no value and is
a later slice.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from fast_tffm_tpu_torch.config import validate_buckets
from fast_tffm_tpu_torch.models.base import Batch

__all__ = ["BucketLadder"]

_FLOAT_SECTIONS = ("labels", "weights", "vals")


class BucketLadder:
    """Routes n-row flushes to the smallest bucket >= n.

    ``score`` is a prediction.ScoreFn; the ladder owns no model state — the
    engine passes the serving state at every call.
    """

    def __init__(self, score, buckets, *, device: torch.device):
        self._score = score
        self.buckets = validate_buckets(buckets)
        self.max_nnz = score.max_nnz
        self.uses_fields = score.uses_fields
        self.device = device
        self.warmed = False

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n.  Callers cap flushes at ``max_batch``, so
        an overflow here is an engine bug, not an input condition."""
        if n < 1 or n > self.buckets[-1]:
            raise ValueError(f"flush of {n} rows outside buckets {self.buckets}")
        return self.buckets[bisect.bisect_left(self.buckets, n)]

    def _sections(self, bucket: int):
        """(name, start, stop, shape) of each section of a bucket's buffer."""
        w = self.max_nnz
        fw = w if self.uses_fields else 0
        out, pos = [], 0
        for name, shape in (
            ("labels", (bucket,)),
            ("weights", (bucket,)),
            ("ids", (bucket, w)),
            ("vals", (bucket, w)),
            ("fields", (bucket, fw)),
        ):
            size = int(np.prod(shape))
            out.append((name, pos, pos + size, shape))
            pos += size
        return out, pos

    def _empty(self, bucket: int):
        """A zeroed staging buffer and writable numpy views of its sections
        (all rows padding, weight 0)."""
        sections, total = self._sections(bucket)
        buf = torch.zeros((total,), dtype=torch.int32, pin_memory=self.device.type == "cuda")
        host = buf.numpy()
        views = {
            name: host[a:b].view(np.float32 if name in _FLOAT_SECTIONS else np.int32).reshape(shape)
            for name, a, b, shape in sections
        }
        return buf, views

    def _finalize(self, buf: torch.Tensor, bucket: int) -> Batch:
        """One host→device copy of the whole buffer, then views on the device.
        Every dispatched batch — warmup and flushes alike — passes here."""
        dev = buf.to(self.device, non_blocking=True)
        sections, _ = self._sections(bucket)
        return Batch(
            **{
                name: dev[a:b].view(torch.float32 if name in _FLOAT_SECTIONS else torch.int32).view(shape)
                for name, a, b, shape in sections
            }
        )

    def _batch(self, bucket: int, rows=()) -> Batch:
        """``rows`` of (ids, vals, fields) placed over an all-padding base."""
        buf, v = self._empty(bucket)
        for i, (rid, rval, rfld) in enumerate(rows):
            v["ids"][i] = rid
            v["vals"][i] = rval
            if self.uses_fields:
                v["fields"][i] = rfld
        v["weights"][: len(rows)] = 1.0
        return self._finalize(buf, bucket)

    def assemble(self, rows) -> tuple[Batch, int]:
        """Parsed request rows [(ids, vals, fields), ...], each already
        width ``max_nnz``, padded up to the nearest bucket."""
        bucket = self.bucket_for(len(rows))
        return self._batch(bucket, rows), bucket

    def assemble_parts(self, parts) -> tuple[Batch, int]:
        """Coalesced assembly: ``parts`` is a list of ``(ids, vals,
        fields_or_None)`` 2-D chunks of width ``max_nnz``; rows land
        contiguously in part order, and the bucket is chosen for the
        coalesced total."""
        n = sum(int(p[0].shape[0]) for p in parts)
        bucket = self.bucket_for(n)
        buf, v = self._empty(bucket)
        pos = 0
        for pid, pval, pfld in parts:
            k = int(pid.shape[0])
            v["ids"][pos : pos + k] = pid
            v["vals"][pos : pos + k] = pval
            if self.uses_fields and pfld is not None:
                v["fields"][pos : pos + k] = pfld
            pos += k
        v["weights"][:n] = 1.0
        return self._finalize(buf, bucket), bucket

    def warmup(self, state) -> None:
        """Score an all-padding batch at every bucket before traffic and wait
        for it: builds and loads the kernel library, and gives the caching
        allocator every flush shape."""
        for bucket in self.buckets:
            self._score(state, self._batch(bucket)).cpu()
        self.warmed = True

    def score(self, state, batch: Batch) -> torch.Tensor:
        return self._score(state, batch)
