"""The device-resident epoch (``device_cache = true``) — the counterpart of
``fast_tffm_tpu/data/device_cache.py``.

The FMB-backed train set is assembled ONCE by ``fmb_batch_stream`` itself
(the same batches, padding, per-file weights and header checks as the
streamed path) into flat row-major arrays ``[batches·B, ...]`` and moved
to the device.  Every step then gathers its batch on the device from a
batch index (rows ``i·B .. i·B+B-1``), or through the epoch's permutation
when shuffling (``perm[i·B ..]``, the streamed path's permutation, so the
shuffled batches are the streamed ones too): no host→device batch copy.
The index, and the permutation, are device tensors; the gathers are
``index_select``s, so a CUDA graph of K steps replays them with nothing
but a [K] index copy (``make_cached_scan_train_step``).

  load_device_dataset(files, ...) -> DeviceDataset
  full_epoch_perm(data, shuffle_seed, epoch) -> the epoch's row order
  make_cached_train_step(model, lr, data, body)       (step, step_shuffled)
  make_cached_scan_train_step(model, lr, data, body)  (step, step_shuffled)
  epoch_index_chunks(batches, k, device, start) -> [K]-long batch-index vectors
  call_ids(data, i, shuffled) -> the ids a call's batches carry (on the card)

Under ``dist_train`` (``load_sharded_device_dataset``) each rank holds only
its block-cyclic ``B / P`` rows of every global batch, the rows its
streamed input would read, on its own device; ``make_cached_sharded_train_step``
runs the mesh-sharded step on batch ``i`` of them, sequentially (a shuffled
epoch would move rows between ranks every step); ``call_ids(data, i,
False)`` gives the delta checkpoint's bitmap and the id statistics the ids
of a call there.

The shuffled steps read ``data.perm``, a device buffer allocated once and
filled per epoch by ``set_permutation``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import k_step_loop, train_step_body
from fast_tffm_tpu_torch.utils.step_graph import StepGraphs
from fast_tffm_tpu_torch.utils.tracing import span

__all__ = [
    "DeviceDataset",
    "load_device_dataset",
    "epoch_permutation",
    "full_epoch_perm",
    "set_permutation",
    "make_cached_train_step",
    "make_cached_scan_train_step",
    "epoch_index_chunks",
    "call_ids",
    "load_sharded_device_dataset",
    "make_cached_sharded_train_step",
]


@dataclasses.dataclass
class DeviceDataset:
    """Flat row-major resident arrays, leading dim [batches·B] (one copy
    serves the sequential and the shuffled gather).  ``batch_size`` is the
    rows of each batch held here: the global batch on one device, a rank's
    ``B / P`` rows of it in a sharded dataset (whose flat arrays are the
    batch-major ``[batches, B / P, ...]`` ones)."""

    labels: torch.Tensor  # f32 [batches·B]
    ids: torch.Tensor  # i32 [batches·B, N]
    vals: torch.Tensor  # f32 [batches·B, N]
    fields: torch.Tensor  # i32 [batches·B, N], or [batches·B, 0] when the model ignores fields
    weights: torch.Tensor  # f32 [batches·B] (0.0 on tail-padding rows)
    batches: int
    batch_size: int
    n_rows: int  # real (unpadded) rows
    offsets: torch.Tensor  # i64 [B]: 0..B-1, the rows of batch 0
    perm: torch.Tensor | None = None  # i64 [batches·B]: the shuffled epoch's row order

    @property
    def arrays(self) -> tuple:
        return (self.labels, self.ids, self.vals, self.fields, self.weights)

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays)


def _load_host_arrays(
    files,
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    weights=None,
    with_fields: bool = False,
    shard_index: int = 0,
    shard_count: int = 1,
):
    """Flat host staging arrays filled batch by batch from
    ``fmb_batch_stream`` (preallocated: a list-then-concatenate would hold
    the dataset on the host twice); ``fields`` [rows, N] ``with_fields``,
    else [rows, 0].  ``shard_count`` > 1 stages only shard ``shard_index``'s
    block-cyclic rows of every global batch of ``batch_size`` (the streamed
    dist_train input's rule), every shard the same number of batches.
    Returns (arrays, batches, n_rows)."""
    from fast_tffm_tpu_torch.data.binary import fmb_batch_stream, open_fmb

    files = [str(f) for f in files]
    n_rows = sum(open_fmb(f).n_rows for f in files)
    if n_rows == 0:
        raise ValueError(f"device_cache: no rows in {files}")
    if batch_size % shard_count:
        raise ValueError(f"device_cache: global batch_size {batch_size} not divisible "
                         f"by {shard_count} processes")
    batches = -(-n_rows // batch_size)  # ceil; the tail pads with weight-0 rows
    local_bs = batch_size // shard_count
    flat = batches * local_bs
    host, lo = None, 0
    for parsed, w in fmb_batch_stream(
        files, batch_size=local_bs, vocabulary_size=vocabulary_size,
        hash_feature_id=hash_feature_id, max_nnz=max_nnz, weights=weights,
        shard_index=shard_index, shard_count=shard_count,
        shard_block=local_bs if shard_count > 1 else 1,
        pad_to_batches=batches if shard_count > 1 else None,
    ):
        if host is None:
            width = parsed.ids.shape[1]
            host = dict(
                labels=np.zeros(flat, np.float32),
                ids=np.zeros((flat, width), np.int32),
                vals=np.zeros((flat, width), np.float32),
                fields=np.zeros((flat, width if with_fields else 0), np.int32),
                weights=np.zeros(flat, np.float32),
            )
        hi = lo + parsed.labels.shape[0]
        host["labels"][lo:hi] = parsed.labels
        host["ids"][lo:hi] = parsed.ids
        host["vals"][lo:hi] = parsed.vals
        if with_fields:
            host["fields"][lo:hi] = parsed.fields
        host["weights"][lo:hi] = w
        lo = hi
    return host, batches, n_rows


def load_device_dataset(
    files,
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    weights=None,
    with_fields: bool = False,
    device="cpu",
) -> DeviceDataset:
    """Assemble FMB files into one DeviceDataset on ``device``: every row
    through ``fmb_batch_stream``, then one copy to the device.  The field
    matrix is carried ``with_fields`` (the model's ``uses_fields``)."""
    host, batches, n_rows = _load_host_arrays(
        files, batch_size=batch_size, vocabulary_size=vocabulary_size,
        hash_feature_id=hash_feature_id, max_nnz=max_nnz, weights=weights,
        with_fields=with_fields,
    )
    put = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return DeviceDataset(
        **put, batches=batches, batch_size=batch_size, n_rows=n_rows,
        offsets=torch.arange(batch_size, dtype=torch.int64, device=device),
    )


def epoch_permutation(shuffle_seed: int, epoch: int, n_rows: int) -> np.ndarray:
    """THE permutation the streamed path draws for this epoch: ``train``
    folds the epoch into the seed and the one-epoch stream draws its epoch
    0 (data/binary.py's helpers, so the two cannot drift)."""
    from fast_tffm_tpu_torch.data.binary import draw_permutation, fold_epoch_seed

    return draw_permutation(fold_epoch_seed(shuffle_seed, epoch), 0, n_rows)


def full_epoch_perm(data: DeviceDataset, shuffle_seed: int, epoch: int) -> np.ndarray:
    """Flat-row order of one shuffled epoch: the streamed path's permutation
    over the real rows, then the tail-padding rows in place (they always
    land in the last batch, as the streamed tail's padding does)."""
    return np.concatenate([
        epoch_permutation(shuffle_seed, epoch, data.n_rows),
        np.arange(data.n_rows, data.batches * data.batch_size, dtype=np.int64),
    ])


def set_permutation(data: DeviceDataset, perm: np.ndarray) -> None:
    """Copy one epoch's row order into ``data.perm`` (allocated at the
    first call and reused, so a captured graph keeps reading it)."""
    src = torch.from_numpy(np.ascontiguousarray(perm, np.int64))
    if data.perm is None:
        data.perm = src.to(data.labels.device)
    else:
        data.perm.copy_(src)


def _batch(data: DeviceDataset, i: torch.Tensor, shuffled: bool) -> Batch:
    """Batch ``i`` (a device index) gathered from the resident arrays (the
    span ``batch``)."""
    with span("batch"):
        rows = i * data.batch_size + data.offsets
        if shuffled:
            rows = data.perm.index_select(0, rows)
        return Batch(*(a.index_select(0, rows) for a in data.arrays))


def call_ids(data: DeviceDataset, i: torch.Tensor, shuffled: bool) -> torch.Tensor:
    """The resident ids [K·B, N] of the batches one call trains on (``i`` a
    0-d batch index or a [K] index chunk), through ``data.perm`` when
    shuffling: what the delta checkpoint's touched-row bitmap and the id
    statistics read after the call, without the batch leaving the card."""
    rows = (i.reshape(-1, 1) * data.batch_size + data.offsets).reshape(-1)
    if shuffled:
        rows = data.perm.index_select(0, rows)
    return data.ids.index_select(0, rows)


def make_cached_train_step(model, learning_rate: float, data: DeviceDataset, body=None):
    """Returns ``(step, step_shuffled)``, each ``(state, i) -> (state,
    data_loss)``: one eager step on batch ``i`` (a 0-d int64 device
    tensor) of the resident arrays, ``step_shuffled`` through
    ``data.perm``.  ``body`` defaults to ``train_step_body`` (the fused
    layout passes its own)."""
    body = body or train_step_body

    def step(state, i):
        return body(model, learning_rate, state, _batch(data, i, False))

    def step_shuffled(state, i):
        return body(model, learning_rate, state, _batch(data, i, True))

    return step, step_shuffled


def make_cached_scan_train_step(model, learning_rate: float, data: DeviceDataset, body=None):
    """K-step twins of ``make_cached_train_step``'s steps, ``(state, idxs
    [K]) -> (state, losses [K])``: the same body on the same gathers, so
    bitwise K sequential steps.  Each is a ``StepGraphs``: on a CUDA state
    captured once per K (the epoch's short tail chunk gets its own graph)
    and replayed, the chunk copied into the graph's static [K] buffer; on
    a CPU state the plain loop."""
    body = body or train_step_body
    return tuple(
        StepGraphs(k_step_loop(model, learning_rate, body,
                               batch_at=lambda k, idxs, s=shuffled: _batch(data, idxs[k], s)))
        for shuffled in (False, True)
    )


def epoch_index_chunks(batches: int, k: int, device="cpu", start: int = 0) -> list[torch.Tensor]:
    """The batch indices of one epoch as [K]-long int64 device vectors plus
    one [batches % K] remainder, placed once and reused every epoch.

    ``start`` > 0 is the exact-position resume's seek: the chunks keep the
    K-grid of an uninterrupted epoch (so every full chunk replays a graph
    already captured for length K) and the first one is clipped to begin
    at ``start``.  A resume that lands mid-chunk makes one extra length;
    a K-aligned one (every save of a K-step run is) makes none."""
    start = max(0, start)
    return [
        torch.arange(max(lo, start), min(lo + k, batches), dtype=torch.int64, device=device)
        for lo in range(start // k * k, batches, k)
        if max(lo, start) < min(lo + k, batches)
    ]


def load_sharded_device_dataset(
    files,
    *,
    mesh,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    weights=None,
    with_fields: bool = False,
    device="cpu",
) -> DeviceDataset:
    """The resident epoch of one rank of ``mesh`` (``dist_train``): its
    block-cyclic ``B / P`` rows of every global batch of ``batch_size``
    (rows ``[r·B/P, (r+1)·B/P)`` of each, the rows the streamed path's
    ``shard_block`` rule gives it), staged on the host and copied once to
    this rank's ``device``.  No rank ever reads another's rows into its
    arrays.  The dataset's ``batch_size`` is the rank's ``B / P``;
    ``batches`` is the global count, the same on every rank, padded with
    weight-0 rows."""
    host, batches, n_rows = _load_host_arrays(
        files, batch_size=batch_size, vocabulary_size=vocabulary_size,
        hash_feature_id=hash_feature_id, max_nnz=max_nnz, weights=weights,
        with_fields=with_fields, shard_index=mesh.rank, shard_count=mesh.size,
    )
    local_bs = batch_size // mesh.size
    put = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return DeviceDataset(
        **put, batches=batches, batch_size=local_bs, n_rows=n_rows,
        offsets=torch.arange(local_bs, dtype=torch.int64, device=device),
    )


def make_cached_sharded_train_step(model, learning_rate: float, mesh, data: DeviceDataset, *,
                                   steps_per_call: int = 1, **step_kw):
    """The mesh-sharded train step (``parallel.make_sharded_train_step``,
    ``step_kw`` its lookup, layout and overflow keys) on the rank's
    resident batches, in order: ``step(state, i) -> (state, loss)`` for a
    0-d device batch index, and at ``steps_per_call`` K > 1 ``step(state,
    idxs [K]) -> (state, losses [K])`` for an ``epoch_index_chunks`` vector,
    the K steps one CUDA graph on the card with their collectives and the
    batch gathers inside.  ``step.overflow_steps`` counts the steps that
    fell back to the all-gather lookup (``lookup_overflow = fallback``).
    At world size 1 this is ``make_cached_train_step`` /
    ``make_cached_scan_train_step``'s step."""
    from fast_tffm_tpu_torch.parallel.train_step import make_sharded_train_step

    return make_sharded_train_step(model, learning_rate, mesh, steps_per_call=steps_per_call,
                                   source=lambda i: _batch(data, i, False), **step_kw)
