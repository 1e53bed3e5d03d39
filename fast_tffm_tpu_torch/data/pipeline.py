"""Host-side input pipeline: text files → line batches → ParsedBatch stream.

The counterpart of ``fast_tffm_tpu/data/pipeline.py`` for libsvm/libffm
text (numpy only).  ``batch_stream`` yields ``(ParsedBatch, weights)``
pairs with a static ``[batch_size, max_nnz]`` shape; a short final batch is
zero-padded with weight-0 rows, so the loss and the AUC ignore them.
Binary FMB input and its cache, shuffling, multi-host sharding and
resume seeks are later slices of the port.
"""

from __future__ import annotations

import itertools
from collections.abc import Iterator, Sequence

import numpy as np

from fast_tffm_tpu_torch.data.libsvm import ParsedBatch, pad_batch, parse_lines

__all__ = ["line_stream", "batch_stream"]


def line_stream(
    files: Sequence[str],
    *,
    epochs: int = 1,
    weights: Sequence[float] | None = None,
) -> Iterator[tuple[str, float]]:
    """Yield (line, example_weight) over ``files`` for ``epochs`` passes,
    skipping blank lines; ``weights`` is a per-file example weight
    (default 1.0)."""
    if weights is not None and len(weights) != len(files):
        raise ValueError(f"weights has {len(weights)} entries for {len(files)} files")
    for _ in range(epochs):
        for fi, path in enumerate(files):
            w = 1.0 if weights is None else float(weights[fi])
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line, w


def batch_stream(
    files: Sequence[str],
    *,
    batch_size: int,
    vocabulary_size: int,
    hash_feature_id: bool = False,
    max_nnz: int | None = None,
    epochs: int = 1,
    weights: Sequence[float] | None = None,
) -> Iterator[tuple[ParsedBatch, np.ndarray]]:
    """Yield (ParsedBatch, example_weights[batch]) with static shapes.

    A short final batch is zero-padded up to ``batch_size`` (padded rows
    get weight 0).  ``max_nnz`` fixes the
    feature-axis width across all batches; None makes each batch as wide as
    its widest row."""
    for p in files:
        if p.endswith((".fmb", ".fms")):
            raise ValueError(
                f"{p}: binary FMB/FMS input is not ported yet (a later slice of "
                "fast_tffm_tpu_torch); stream the text file"
            )
    stream = line_stream(files, epochs=epochs, weights=weights)
    while True:
        chunk = list(itertools.islice(stream, batch_size))
        if not chunk:
            return
        w = np.asarray([c[1] for c in chunk], np.float32)
        batch = parse_lines(
            [c[0] for c in chunk],
            vocabulary_size=vocabulary_size,
            hash_feature_id_flag=hash_feature_id,
            max_nnz=max_nnz,
        )
        if len(chunk) < batch_size:
            batch = pad_batch(batch, batch_size)
            w = np.concatenate([w, np.zeros((batch_size - len(chunk),), np.float32)])
        yield batch, w
