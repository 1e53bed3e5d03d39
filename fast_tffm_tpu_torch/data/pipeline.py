"""Host-side input pipeline: files → ParsedBatch stream — the counterpart
of ``fast_tffm_tpu/data/pipeline.py``.

``batch_stream`` yields ``(ParsedBatch, weights)`` pairs with a static
``[batch_size, max_nnz]`` shape; a short final batch is zero-padded with
weight-0 rows, so the loss and the AUC ignore them.  It routes by input:

* FMB files (data/binary.py) → ``fmb_batch_stream``: memmap copies, no
  parsing, and the only input that shuffles;
* text with the native parser (data/native.py) → ``native_batch_stream``:
  reading, splitting and parsing in C++;
* text otherwise → the Python line stream and ``parser`` (default
  ``libsvm.parse_lines``).

``skip_rows`` (a whole number of batches) is the exact-position resume's
seek on every route.  ``shard_index`` / ``shard_count`` / ``shard_block``
shard every route block-cyclically by global line index (line i goes to
shard ``(i // shard_block) % shard_count``): with the block at the local
batch size, rank p of P parses exactly rows ``[p·B/P, (p+1)·B/P)`` of every
global batch (``dist_train``); ``pad_to_batches`` pads a short shard with
weight-0 batches, so every rank runs the same number of steps.
"""

from __future__ import annotations

import itertools
from collections.abc import Iterator, Sequence

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import ParsedBatch, pad_batch, parse_lines

__all__ = ["line_stream", "batch_stream", "emit_assembled_tail"]


def emit_assembled_tail(alloc, buffers, filled, emitted, drop_remainder, pad_to_batches):
    """The end of a buffer-assembling stream (``native_batch_stream``,
    ``fmb_batch_stream``): ``buffers`` (labels, ids, vals, fields, nnz,
    weights) holds ``filled`` real rows, zeros with weight 0 beyond
    (``pad_batch``'s padding).  Emits that short batch unless
    ``drop_remainder``, then all-empty weight-0 batches up to
    ``pad_to_batches``."""
    labels, ids, vals, fields, nnz, w = buffers
    if filled and not drop_remainder and (pad_to_batches is None or emitted < pad_to_batches):
        yield ParsedBatch(labels, ids, vals, fields, nnz), w
        emitted += 1
    if pad_to_batches is not None:
        while emitted < pad_to_batches:
            labels, ids, vals, fields, nnz, w = alloc()  # all-zero, weight-0
            yield ParsedBatch(labels, ids, vals, fields, nnz), w
            emitted += 1


def check_shard_block(shard_block: int, epochs: int) -> None:
    """``shard_block > 1`` needs one pass: the line counter runs across
    epoch repeats, so a second pass would start mid-block."""
    if shard_block > 1 and epochs != 1:
        raise ValueError(
            "shard_block > 1 requires epochs == 1 (batch-aligned sharding "
            "does not survive epoch boundaries); create one stream per epoch"
        )


def line_stream(
    files: Sequence[str],
    *,
    epochs: int = 1,
    shard_index: int = 0,
    shard_count: int = 1,
    shard_block: int = 1,
    weights: Sequence[float] | None = None,
) -> Iterator[tuple[str, float]]:
    """Yield (line, example_weight) over ``files`` for ``epochs`` passes,
    skipping blank lines; ``weights`` is a per-file example weight
    (default 1.0).  Sharded block-cyclically by global non-blank line index
    (see the module docstring)."""
    if weights is not None and len(weights) != len(files):
        raise ValueError(f"weights has {len(weights)} entries for {len(files)} files")
    check_shard_block(shard_block, epochs)
    counter = itertools.count()
    block = max(1, shard_block)
    for _ in range(epochs):
        for fi, path in enumerate(files):
            w = 1.0 if weights is None else float(weights[fi])
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line and (next(counter) // block) % shard_count == shard_index:
                        yield line, w


def batch_stream(
    files: Sequence[str],
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    epochs: int = 1,
    shard_index: int = 0,
    shard_count: int = 1,
    shard_block: int = 1,
    weights: Sequence[float] | None = None,
    drop_remainder: bool = False,
    pad_to_batches: int | None = None,
    parser=None,
    binary_cache: bool = False,
    shuffle_seed: int | None = None,
    skip_rows: int = 0,
    io_retries: int = 3,
    io_retry_backoff_s: float = 0.05,
    log=print,
) -> Iterator[tuple[ParsedBatch, np.ndarray]]:
    """Yield (ParsedBatch, example_weights[batch]) with static shapes.

    A short final batch is zero-padded up to ``batch_size`` (padded rows get
    weight 0) unless ``drop_remainder``.  ``max_nnz`` fixes the feature-axis
    width across all batches; None makes each batch as wide as its widest
    row.  ``pad_to_batches`` forces exactly that many batches, appending
    all-empty weight-0 ones (requires ``max_nnz``).

    ``parser`` overrides the line parser (``parse_lines``' signature); the
    native parser streams whole files through C++ when ``max_nnz`` is set.
    ``binary_cache`` converts text files to ``<file>.fmb`` caches first
    (reused while fresh) and streams those.  ``shuffle_seed`` shuffles the
    rows of every epoch and needs FMB input.  A list mixing FMB and text
    files is refused.

    ``skip_rows`` (a whole number of batches) reopens the stream mid-epoch,
    the exact-position resume's seek: FMB streams seek in the memmap (in
    the permuted order when shuffled), the Python text path skips raw
    lines before parsing, and the native path drops the first
    ``skip_rows / batch_size`` parsed batches (it has no random access).
    Skipped batches count as emitted for ``pad_to_batches``, so a resumed
    stream emits exactly the remaining batches.  ``shard_*``: this shard's
    lines only (the module docstring); ``skip_rows`` counts rows of the
    shard."""
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache, fmb_batch_stream, is_fmb
    from fast_tffm_tpu_torch.data.native import NativeParser, native_batch_stream

    if skip_rows < 0 or skip_rows % batch_size:
        raise ValueError(
            f"skip_rows must be a non-negative whole number of batches "
            f"(batch_size {batch_size}), got {skip_rows}"
        )
    skip_batches = skip_rows // batch_size
    shard = dict(shard_index=shard_index, shard_count=shard_count, shard_block=shard_block)
    if pad_to_batches is not None and max_nnz is None:
        raise ValueError(
            "pad_to_batches requires max_nnz (pad batches must share the "
            "data batches' static feature width)"
        )
    if binary_cache:
        files = ensure_fmb_cache(
            files, vocabulary_size=vocabulary_size, hash_feature_id=hash_feature_id,
            max_nnz=max_nnz, parser=parser, log=log,
        )
    fmb = [is_fmb(p) for p in files]
    if any(fmb):
        if not all(fmb):
            raise ValueError(
                "cannot mix FMB and text files in one stream: "
                f"{[p for p, b in zip(files, fmb) if not b]} are not FMB"
            )
        yield from fmb_batch_stream(
            files, batch_size=batch_size, vocabulary_size=vocabulary_size,
            hash_feature_id=hash_feature_id, max_nnz=max_nnz, epochs=epochs, **shard,
            weights=weights, drop_remainder=drop_remainder, pad_to_batches=pad_to_batches,
            shuffle_seed=shuffle_seed, skip_rows=skip_rows, io_retries=io_retries,
            io_retry_backoff_s=io_retry_backoff_s, log=log,
        )
        return
    if shuffle_seed is not None:
        if binary_cache:
            raise ValueError(
                "shuffle requires memmap (FMB) input, and the binary cache "
                "could not be built (cache location unwritable?) — fix the "
                "cache-directory permissions so that binary_cache = true can "
                "write it"
            )
        raise ValueError(
            "shuffle requires memmap (FMB) input — sequential text streaming "
            "cannot reorder rows; set binary_cache = true"
        )
    if isinstance(parser, NativeParser) and max_nnz is not None:
        gen = native_batch_stream(
            parser, files, batch_size=batch_size, vocabulary_size=vocabulary_size,
            hash_feature_id=hash_feature_id, max_nnz=max_nnz, epochs=epochs, **shard,
            weights=weights, drop_remainder=drop_remainder, pad_to_batches=pad_to_batches,
        )
        # pad_to_batches counts the dropped batches: N emitted underneath,
        # the first skip_batches dropped, the remaining N - skip yielded.
        yield from itertools.islice(gen, skip_batches, None)
        return

    parse = parser if parser is not None else parse_lines
    stream = itertools.islice(line_stream(files, epochs=epochs, weights=weights, **shard),
                              skip_rows, None)
    emitted = skip_batches
    while True:
        chunk = list(itertools.islice(stream, batch_size))
        if not chunk or (len(chunk) < batch_size and drop_remainder):
            break
        w = np.asarray([c[1] for c in chunk], np.float32)
        batch = parse(
            [c[0] for c in chunk],
            vocabulary_size=vocabulary_size,
            hash_feature_id_flag=hash_feature_id,
            max_nnz=max_nnz,
        )
        if len(chunk) < batch_size:
            batch = pad_batch(batch, batch_size)
            w = np.concatenate([w, np.zeros((batch_size - len(chunk),), np.float32)])
        yield batch, w
        emitted += 1
        if pad_to_batches is not None and emitted >= pad_to_batches:
            return
    if pad_to_batches is not None:
        while emitted < pad_to_batches:
            empty = ParsedBatch(
                labels=np.zeros((batch_size,), np.float32),
                ids=np.zeros((batch_size, max_nnz), np.int64),
                vals=np.zeros((batch_size, max_nnz), np.float32),
                fields=np.zeros((batch_size, max_nnz), np.int32),
                nnz=np.zeros((batch_size,), np.int32),
            )
            yield empty, np.zeros((batch_size,), np.float32)
            emitted += 1
