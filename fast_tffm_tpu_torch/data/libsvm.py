"""libsvm / libffm text parsing into padded, static-width batches.

A copy of ``fast_tffm_tpu/data/libsvm.py``'s ``parse_lines`` contract
(numpy only): ``label tok tok ...`` lines, ``feat:val`` or
``field:feat:val`` tokens, a padded ``[batch, max_nnz]`` output where
zero-valued padding is neutral in the FM math, and the same ``ValueError``
messages for malformed input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fast_tffm_tpu_torch.data.hashing import hash_feature_id

__all__ = ["ParsedBatch", "parse_lines", "pad_batch", "scan_max_nnz"]


@dataclasses.dataclass
class ParsedBatch:
    """A padded batch on the host.

    labels [B] f32 in {0, 1}; ids [B, N] int64 (0-padded); vals [B, N] f32
    (0 marks padding); fields [B, N] int32; nnz [B] int32 true widths.
    """

    labels: np.ndarray
    ids: np.ndarray
    vals: np.ndarray
    fields: np.ndarray
    nnz: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.labels.shape[0])

    @property
    def max_nnz(self) -> int:
        return int(self.ids.shape[1])


def _parse_label(tok: str) -> float:
    y = float(tok)
    return 0.0 if y <= 0.0 else 1.0


def parse_lines(
    lines: list[str],
    *,
    vocabulary_size: int,
    hash_feature_id_flag: bool = False,
    max_nnz: int | None = None,
) -> ParsedBatch:
    """Parse libsvm/libffm text lines into a ParsedBatch; malformed tokens,
    out-of-range ids and over-wide rows raise ValueError naming the line."""
    n = len(lines)
    labels = np.zeros((n,), np.float32)
    per_row: list[tuple[list[int], list[float], list[int]]] = []
    widest = 0
    for li, line in enumerate(lines):
        toks = line.split()
        if not toks:
            raise ValueError(f"empty line at index {li}")
        try:
            labels[li] = _parse_label(toks[0])
        except ValueError as e:
            raise ValueError(f"bad label {toks[0]!r} at line {li}") from e
        ids_, vals_, flds_ = [], [], []
        for tok in toks[1:]:
            parts = tok.split(":")
            try:
                if len(parts) == 2:
                    fld, feat, val = 0, parts[0], float(parts[1])
                elif len(parts) == 3:
                    fld, feat, val = int(parts[0]), parts[1], float(parts[2])
                else:
                    raise ValueError(tok)
            except ValueError as e:
                raise ValueError(f"bad token {tok!r} at line {li}") from e
            if hash_feature_id_flag:
                fid = hash_feature_id(feat, vocabulary_size)
            else:
                fid = int(feat)
                if not 0 <= fid < vocabulary_size:
                    raise ValueError(
                        f"feature id {fid} out of range [0, {vocabulary_size}) "
                        f"at line {li} (set hash_feature_id = True for raw tokens)"
                    )
            ids_.append(fid)
            vals_.append(val)
            flds_.append(fld)
        per_row.append((ids_, vals_, flds_))
        widest = max(widest, len(ids_))

    width = max_nnz if max_nnz is not None else max(widest, 1)
    ids = np.zeros((n, width), np.int64)
    vals = np.zeros((n, width), np.float32)
    fields = np.zeros((n, width), np.int32)
    nnz = np.zeros((n,), np.int32)
    for li, (ids_, vals_, flds_) in enumerate(per_row):
        if len(ids_) > width:
            raise ValueError(f"line {li} has {len(ids_)} features > max_nnz={width}")
        m = len(ids_)
        ids[li, :m] = ids_
        with np.errstate(over="ignore"):  # huge decimals -> inf, like the C++ cast
            vals[li, :m] = vals_
        fields[li, :m] = flds_
        nnz[li] = m
    return ParsedBatch(labels=labels, ids=ids, vals=vals, fields=fields, nnz=nnz)


def pad_batch(batch: ParsedBatch, batch_size: int) -> ParsedBatch:
    """Pad a short tail batch up to ``batch_size`` rows with empty examples
    (nnz 0, label 0, all-zero vals: score 0); callers weight them out."""
    n = batch.batch_size
    if n == batch_size:
        return batch
    if n > batch_size:
        raise ValueError(f"batch of {n} rows exceeds target {batch_size}")
    pad = batch_size - n
    return ParsedBatch(
        labels=np.concatenate([batch.labels, np.zeros((pad,), np.float32)]),
        ids=np.concatenate([batch.ids, np.zeros((pad, batch.max_nnz), batch.ids.dtype)]),
        vals=np.concatenate([batch.vals, np.zeros((pad, batch.max_nnz), np.float32)]),
        fields=np.concatenate([batch.fields, np.zeros((pad, batch.max_nnz), np.int32)]),
        nnz=np.concatenate([batch.nnz, np.zeros((pad,), np.int32)]),
    )


def scan_max_nnz(cfg) -> int:
    """The static feature width: ``cfg.max_nnz``, or the widest row of the
    configured data files (``fast_tffm_tpu/training.py::scan_max_nnz``'s
    contract): one C++ pass per text file, the header of an FMB file
    (``data/native.scan_files``), and the header width of an FMS stream
    (``data/stream.py``: an append-only file's widest future row is
    unknowable, so the writer's declared width is the bound)."""
    if cfg.max_nnz > 0:
        return cfg.max_nnz
    from fast_tffm_tpu_torch.data.native import scan_files
    from fast_tffm_tpu_torch.data.stream import is_fms, read_fms_header

    paths = (*cfg.train_files, *cfg.validation_files, *cfg.predict_files)
    if not paths:
        raise ValueError(
            "serving needs a static feature width: set max_nnz in [Train], "
            "or configure data files for the width scan"
        )
    fms_widths = [read_fms_header(p)["width"] for p in paths if is_fms(p)]
    rest = tuple(p for p in paths if not is_fms(p))
    widest = scan_files(rest)[1] if rest else 0
    return max(1, widest, *fms_widths)
