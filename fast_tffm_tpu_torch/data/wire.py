"""The packed wire: one host→device buffer per batch or K-group — the
counterpart of ``fast_tffm_tpu/data/wire.py``.

The arrays path copies every tensor of a batch (labels, ids, vals, fields,
weights) to the card on its own.  The packed wire puts them into ONE
little-endian byte buffer, copied with one H2D, and leaves out what the
card can rebuild exactly:

  * ``vals`` of an all-ones stream (the FMB v2 header flag): rebuilt as
    ``arange(N) < nnz``, the 1.0/0.0 pattern the parser produced;
  * ``fields`` for a model that never reads them (FM, DeepFM);
  * ``weights`` when the per-file example weights are 1.0: rebuilt from
    the batch's real-row count (padding rows are a weight-0 suffix);
  * ids at the least byte width of the vocabulary, labels as one byte,
    ``nnz`` at the least width of ``max_nnz``.

Per batch the layout is (little-endian)::

    n_real   u32                1
    labels   u8                 B
    nnz      u8|u16|u32         B        only when vals are left out
    weights  f32                B        only when with_weights
    ids      u8 x id_bytes      B*N
    vals     f32                B*N      only when with_vals
    fields   i32                B*N      only when with_fields

A K-group is ``[K, L]``.  The packer is numpy and writes the JAX package's
bytes; it checks every left-out section against the host arrays and raises
on a mismatch, so a wrong header flag never trains on rebuilt values.
``make_unpacker(spec)`` is torch on the buffer's device: slices, byte
pads and ``view`` bitcasts, so the Batch it gives is bitwise the arrays
path's.  ``WireConverter`` is the converting thread's shipper (training
reads in one prefetch thread and converts in a second): it packs into
a pinned buffer, copies it to the card and unpacks it there on a side
stream, and hands the loop a ``Staged`` batch whose ``ready()`` makes the
loop's stream wait for that work.
"""

from __future__ import annotations

import functools
import sys
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "WireSpec",
    "make_spec",
    "bytes_for",
    "vals_all_ones",
    "pack_batch",
    "pack_superbatch",
    "make_unpacker",
    "WireConverter",
    "PinnedStager",
    "Staged",
    "arrays_nbytes",
]

# The packed wire assumes a little-endian host; checked in make_spec (the
# pack path's gate), not at import.
_LITTLE_ENDIAN = sys.byteorder == "little"


class WireSpec(NamedTuple):
    """Static facts of one packed-wire stream.  B and K come off the buffer."""

    nnz: int  # N, the static feature width of every batch
    id_bytes: int  # 1..4, least LE width for vocabulary_size - 1
    nnz_bytes: int  # 1..4, least LE width for nnz
    with_vals: bool  # False: an all-ones stream, vals rebuilt on the device
    with_fields: bool  # False: the model never reads fields
    with_weights: bool  # False: uniform file weights, rebuilt from n_real

    @property
    def with_nnz(self) -> bool:
        """The nnz section rides only when the elided-vals rebuild reads it."""
        return not self.with_vals

    @property
    def row_bytes(self) -> int:
        n = self.nnz
        return (
            1
            + (self.nnz_bytes if self.with_nnz else 0)
            + (4 if self.with_weights else 0)
            + n * self.id_bytes
            + (4 * n if self.with_vals else 0)
            + (4 * n if self.with_fields else 0)
        )

    def batch_nbytes(self, batch_size: int) -> int:
        """Wire bytes of one batch (the 4-byte n_real included)."""
        return 4 + batch_size * self.row_bytes


def bytes_for(maxval: int) -> int:
    """Least little-endian byte width holding ``maxval`` (1..4)."""
    for k in (1, 2, 3):
        if maxval < 1 << (8 * k):
            return k
    return 4


def make_spec(
    vocabulary_size: int,
    max_nnz: int,
    *,
    with_vals: bool,
    with_fields: bool,
    with_weights: bool = False,
) -> WireSpec:
    if not _LITTLE_ENDIAN:  # pragma: no cover - no big-endian hosts in practice
        raise ValueError(
            "the packed wire format assumes a little-endian host (all "
            "TPU/GPU hosts are); set wire_format = arrays on this platform"
        )
    return WireSpec(
        nnz=int(max_nnz),
        id_bytes=bytes_for(max(1, int(vocabulary_size) - 1)),
        nnz_bytes=bytes_for(max(1, int(max_nnz))),
        with_vals=bool(with_vals),
        with_fields=bool(with_fields),
        with_weights=bool(with_weights),
    )


def arrays_nbytes(batch_size: int, nnz: int, with_fields: bool) -> int:
    """H2D bytes the arrays path copies for the same batch (labels f32 +
    ids i32 + vals f32 + weights f32 [+ fields i32])."""
    per_row = 4 + 4 * nnz + 4 * nnz + 4 + (4 * nnz if with_fields else 0)
    return batch_size * per_row


def vals_all_ones(vals, nnz) -> bool:
    """True when ``vals`` is exactly the pattern its ``nnz`` implies: 1.0 in
    the first nnz[i] slots of row i, 0.0 beyond."""
    vals = np.asarray(vals, np.float32)
    nnz = np.asarray(nnz).reshape(-1, 1)
    expect = (np.arange(vals.shape[1]) < nnz).astype(np.float32)
    return bool(np.array_equal(vals, expect))


def _put_uint(dst: np.ndarray, a, k: int) -> None:
    """Integer array → its ``k`` low little-endian bytes per element, written
    straight into the flat uint8 ``dst`` from strided views of ``a``'s own
    bytes (the two's-complement low bytes, as a cast to uint32 gives them):
    no temporary the size of the batch.  k = 3 writes a (u2, u1) record per
    value; numpy copies a 3-byte slice a byte at a time, several times
    slower."""
    a = np.ascontiguousarray(a).reshape(-1)
    s = a.dtype.itemsize
    if s not in (4, 8):
        a, s = a.astype("<u4"), 4
    low = a.view("<u4")[:: s // 4]  # each value's low word
    if k == 4:
        dst.view("<u4")[:] = low
    elif k == 2:
        np.copyto(dst.view("<u2"), low, casting="unsafe")
    elif k == 1:
        np.copyto(dst, low, casting="unsafe")
    else:
        rec = dst.view(np.dtype([("lo", "<u2"), ("hi", "u1")]))
        np.copyto(rec["lo"], low, casting="unsafe")
        rec["hi"] = a.view(np.uint8)[2::s]


def _pack_one(spec: WireSpec, out: np.ndarray, parsed, w, verify_ids=True) -> None:
    """Fill one batch's flat byte vector ``out``.  ``verify_ids=False``
    skips the id-range scan for ids already known to be in range (the
    tiered converter's slots); labels, weights and vals stay verified."""
    b, n = parsed.batch_size, spec.nnz
    if parsed.max_nnz != n:
        raise ValueError(f"packed wire: batch width {parsed.max_nnz} != spec nnz {n}")
    labels = np.asarray(parsed.labels, np.float32)
    w = np.asarray(w, np.float32)
    n_real = int(np.count_nonzero(w))
    o = 0

    def put(a):
        nonlocal o
        flat = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        out[o : o + flat.size] = flat
        o += flat.size

    def put_uint(a, k):
        nonlocal o
        _put_uint(out[o : o + a.size * k], a, k)
        o += a.size * k

    if not spec.with_weights and not (
        np.all(w[:n_real] == 1.0) and not w[n_real:].any()
    ):
        raise ValueError(
            "packed wire: example weights are not the uniform 1.0-prefix "
            "pattern this spec elides (non-uniform weight_files need "
            "with_weights=True)"
        )
    put(np.array([n_real], "<u4"))
    lab8 = labels.astype(np.uint8)
    if not np.array_equal(lab8.astype(np.float32), labels):
        raise ValueError(
            "packed wire: labels outside {0, 1} — the parser contract the "
            "1-byte label section relies on"
        )
    put(lab8)
    if spec.with_nnz:
        put_uint(parsed.nnz, spec.nnz_bytes)
    if spec.with_weights:
        put(w)
    # One pass: a negative id or one past the width sets a bit above it.
    if (verify_ids and spec.id_bytes < 4 and parsed.ids.size
            and int(np.bitwise_or.reduce(parsed.ids, axis=None)) >> (8 * spec.id_bytes)):
        lo, hi = int(parsed.ids.min()), int(parsed.ids.max())
        if lo < 0 or hi >= 1 << (8 * spec.id_bytes):
            raise ValueError(
                f"packed wire: ids span [{lo}, {hi}] but the spec's "
                f"id_bytes={spec.id_bytes} only holds "
                f"[0, {1 << (8 * spec.id_bytes)}) — spec built for the "
                "wrong vocabulary_size?"
            )
    put_uint(parsed.ids, spec.id_bytes)
    if spec.with_vals:
        put(np.asarray(parsed.vals, np.float32))
    elif not vals_all_ones(parsed.vals, parsed.nnz):
        raise ValueError(
            "packed wire: vals are not the all-ones pattern this spec "
            "elides — re-convert the file (tools/convert_dataset.py) or "
            "set wire_format = arrays"
        )
    if spec.with_fields:
        put(np.ascontiguousarray(parsed.fields, dtype="<i4"))
    if o != out.size:
        raise AssertionError(f"wire layout mismatch: wrote {o} of {out.size}")


def pack_batch(spec: WireSpec, parsed, w, verify_ids=True, out=None) -> np.ndarray:
    """One ParsedBatch → flat uint8 wire vector ``[L]`` (into ``out`` when
    given, a uint8 array of that length)."""
    if out is None:
        out = np.empty(spec.batch_nbytes(parsed.batch_size), np.uint8)
    _pack_one(spec, out, parsed, w, verify_ids)
    return out


def pack_superbatch(spec: WireSpec, parsed_seq, w_seq, verify_ids=True, out=None) -> np.ndarray:
    """K ParsedBatches → ``[K, L]`` wire matrix (into ``out`` when given)."""
    k = len(parsed_seq)
    b = parsed_seq[0].batch_size
    if out is None:
        out = np.empty((k, spec.batch_nbytes(b)), np.uint8)
    if w_seq is None:
        w_seq = [None] * k
    for i, (p, w) in enumerate(zip(parsed_seq, w_seq)):
        _pack_one(spec, out[i], p, np.ones((b,), np.float32) if w is None else w, verify_ids)
    return out


def wire_nbytes(spec: WireSpec, parsed) -> int:
    """Bytes ``pack_batch`` / ``pack_superbatch`` write for ``parsed`` (a
    ParsedBatch or a K-list)."""
    seq = parsed if isinstance(parsed, list) else [parsed]
    return len(seq) * spec.batch_nbytes(seq[0].batch_size)


def pack_into(spec: WireSpec, out: np.ndarray, parsed, w, verify_ids=True) -> None:
    """``parsed`` (a ParsedBatch or a K-list) packed into the flat ``out``."""
    if isinstance(parsed, list):
        pack_superbatch(spec, parsed, w, verify_ids,
                        out=out.reshape(len(parsed), -1))
    else:
        pack_batch(spec, parsed,
                   np.ones((parsed.batch_size,), np.float32) if w is None else w,
                   verify_ids, out=out)


def _bitcast(x: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 [..., 4m] → ``dtype`` [..., m] (a 4-byte type), bit for bit.
    The slice is copied first: a view of another element size needs an
    aligned, contiguous start."""
    return x.clone().view(dtype)


def _as_i32(x: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 [..., m*k] little-endian k-byte integers → int32 [..., m]: each
    value's bytes padded with zero high bytes to 4 and bitcast (k = 4: the
    word itself, a sign bit included).  Two device ops whatever k is."""
    if k == 4:
        return _bitcast(x, torch.int32)
    lead = x.shape[:-1]
    words = torch.nn.functional.pad(x.reshape(*lead, -1, k), (0, 4 - k))
    return words.reshape(*lead, -1).view(torch.int32)


@functools.lru_cache(maxsize=None)
def make_unpacker(spec: WireSpec):
    """``unpack(buf uint8 [..., L]) -> Batch`` in torch, on ``buf``'s
    device.  Leading dims pass through ([L] → a [B, ...] batch, [K, L] →
    the [K, B, ...] superbatch).  f32 sections come back by bitcast,
    the left-out vals and weights as their verified 1.0/0.0 patterns,
    labels from the {0, 1} bytes: bitwise the arrays path.  Memoized per
    spec, as the JAX package memoizes its jitted program."""
    from fast_tffm_tpu_torch.models.base import Batch

    n, rb = spec.nnz, spec.row_bytes
    as_i32 = _as_i32

    def unpack(buf: torch.Tensor):
        *lead, length = buf.shape
        lead = tuple(lead)
        b = (length - 4) // rb
        o = 0

        def take(nbytes):
            nonlocal o
            s = buf[..., o : o + nbytes]
            o += nbytes
            return s

        n_real = _bitcast(take(4), torch.int32).reshape(lead)
        labels = take(b).to(torch.float32)
        if spec.with_nnz:
            nnz = as_i32(take(b * spec.nnz_bytes), spec.nnz_bytes)
        if spec.with_weights:
            weights = _bitcast(take(4 * b), torch.float32)
        else:
            weights = (torch.arange(b, device=buf.device) < n_real[..., None]).to(torch.float32)
        ids = as_i32(take(b * n * spec.id_bytes), spec.id_bytes).reshape(*lead, b, n)
        if spec.with_vals:
            vals = _bitcast(take(4 * b * n), torch.float32).reshape(*lead, b, n)
        else:
            vals = (torch.arange(n, device=buf.device) < nnz[..., None]).to(torch.float32)
        if spec.with_fields:
            fields = as_i32(take(4 * b * n), 4).reshape(*lead, b, n)
        else:
            fields = torch.zeros((*lead, b, 0), dtype=torch.int32, device=buf.device)
        return Batch(labels=labels, ids=ids, vals=vals, fields=fields, weights=weights)

    return unpack


class Staged(NamedTuple):
    """What a converter hands the training loop: ``value`` (a Batch or a
    tiered payload) made on the prefetch thread's side stream.  ``ready()``
    makes the current stream wait for that work and marks its tensors as
    used there (so the caching allocator does not hand their memory to the
    side stream while the loop still reads them), then returns ``value``."""

    value: object
    event: object  # torch.cuda.Event, or None on the CPU
    tensors: tuple

    def ready(self):
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
        return self.value


class PinnedStager:
    """Host→device staging for one stream: a ring of ``slots`` pinned
    buffers and a side stream.  ``buffer(nbytes)`` hands out the next slot
    as a numpy uint8 array, first waiting for that slot's last copy to
    finish (a buffer is never refilled under a copy in flight);
    ``ship(nbytes)`` copies it to a new device tensor on the side stream.
    On the CPU the "buffer" is a plain array and ``ship`` a view of it."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._slots: list = [None] * max(1, int(slots))  # (pinned tensor, event)
        self._i = 0
        self._current = None
        # A high-priority stream: PyTorch hands out pooled streams round
        # robin, and a default-priority one can be the stream a CUDA graph
        # captures on (``torch.cuda.graph``'s default capture stream), whose
        # capture would take in this thread's copies and unpacks.
        self.stream = torch.cuda.Stream(self.device, priority=-1) if self.cuda else None

    def buffer(self, nbytes: int) -> np.ndarray:
        if not self.cuda:
            self._current = torch.empty(nbytes, dtype=torch.uint8)
            return self._current.numpy()
        slot = self._slots[self._i]
        if slot is not None and slot[1] is not None:
            slot[1].synchronize()  # its last H2D is done before it is refilled
        if slot is None or slot[0].numel() < nbytes:
            slot = (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True), slot and slot[1])
            self._slots[self._i] = slot
        self._current = slot[0][:nbytes]
        return self._current.numpy()

    def ship(self) -> torch.Tensor:
        """The buffer last handed out, on the device (its H2D queued on the
        side stream; the slot's event is recorded behind it)."""
        host = self._current
        if not self.cuda:
            return host
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._slots[self._i] = (self._slots[self._i][0], done)
        self._i = (self._i + 1) % len(self._slots)
        return dev

    def staged(self, value, tensors) -> Staged:
        """``value`` (made from ``tensors`` on the side stream) for the loop."""
        if not self.cuda:
            return Staged(value, None, tuple(tensors))
        done = torch.cuda.Event()
        done.record(self.stream)
        return Staged(value, done, tuple(tensors))

    def side(self):
        """The side stream as a context (a no-op on the CPU)."""
        import contextlib

        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()


def batch_tensors(batch) -> tuple:
    from dataclasses import fields

    return tuple(getattr(batch, f.name) for f in fields(batch))


class WireConverter:
    """The converting thread's packed-wire shipper: pack into a pinned
    buffer, ONE host→device copy and the unpack on the device, both on a
    side stream; returns a ``Staged`` Batch (``[B, ...]``, or ``[K, B,
    ...]`` for a K-list).  ``last_nbytes`` / ``wire_bytes`` / ``calls``
    feed the kind=input records."""

    def __init__(self, spec: WireSpec, device, *, slots: int = 2, verify_ids: bool = True):
        self.spec = spec
        self.verify_ids = verify_ids
        self._unpack = make_unpacker(spec)
        self._stager = PinnedStager(device, slots)
        self.last_nbytes = 0
        self.wire_bytes = 0
        self.calls = 0

    def __call__(self, parsed, w) -> Staged:
        nbytes = wire_nbytes(self.spec, parsed)
        pack_into(self.spec, self._stager.buffer(nbytes), parsed, w, self.verify_ids)
        buf = self._stager.ship()
        if isinstance(parsed, list):
            buf = buf.view(len(parsed), -1)
        with self._stager.side():
            batch = self._unpack(buf)
        self.last_nbytes = nbytes
        self.wire_bytes += nbytes
        self.calls += 1
        return self._stager.staged(batch, batch_tensors(batch))
