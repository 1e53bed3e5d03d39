"""INI config for the port: the JAX package's key vocabulary, cut to serving.

A copy of ``fast_tffm_tpu/config.py`` reduced to what the serving path
reads.  It parses the same files (``sample.cfg``, ``configs/*.cfg``) with
the same sections, keys and defaults; keys it does not model are ignored,
as they are by ``ConfigParser`` reads of absent options.  Configurations
this port cannot serve yet are refused with a ``ValueError`` that names
the missing piece, never served differently.
"""

from __future__ import annotations

import configparser
import dataclasses
import glob

__all__ = ["Config", "load_config", "validate_buckets", "validate_classes", "build_model"]


@dataclasses.dataclass
class Config:
    # [General]
    model: str = "fm"  # fm (ffm | deepfm are later slices of the port)
    factor_num: int = 8
    order: int = 2
    vocabulary_size: int = 1 << 20
    hash_feature_id: bool = False
    table_layout: str = "rows"  # rows (packed is a later slice)
    model_file: str = "model.ckpt"
    checkpoint_format: str = "npz"  # npz (orbax is a later slice)
    # [Train] — the keys the serving path reads (the L2 lambdas and the rest
    #   of the section arrive with the training slice)
    train_files: tuple[str, ...] = ()
    validation_files: tuple[str, ...] = ()
    max_nnz: int = 0  # 0 = infer from a scan of the data files
    init_value_range: float = 0.01
    wire_format: str = "packed"  # read for parity; the port always stages
    #   one pinned host->device buffer per flush (serving/buckets.py), and
    #   the packed wire (data/wire.py) changes no value
    # [Predict]
    predict_files: tuple[str, ...] = ()
    # [Serving]
    serve_buckets: tuple[int, ...] = (1, 8, 64, 512)  # batch-size ladder;
    #   every flush pads to the nearest rung
    serve_max_batch: int = 0  # collector flush size; 0 = largest bucket
    serve_flush_deadline_ms: float = 5.0  # max micro-batching wait for the
    #   oldest pending request (0 = flush instantly)
    serve_queue_size: int = 4096  # bounded admission queue
    serve_overload: str = "block"  # queue-full policy: block | reject
    serve_reload_interval_s: float = 0.0  # hot reload (a later slice: > 0 raises
    #   at engine construction)
    serve_port: int = 0  # socket front end (a later slice); 0 = pipe mode
    serve_deadline_ms: float = 0.0  # default per-request deadline; 0 = none
    serve_classes: tuple[tuple[str, int], ...] = ()  # class -> admission tier

    def validate(self) -> "Config":
        if self.model not in ("fm", "ffm", "deepfm"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.model != "fm":
            raise ValueError(
                f"model = {self.model} is not ported yet (FFM and DeepFM are a "
                "later slice of fast_tffm_tpu_torch); use fast_tffm_tpu"
            )
        if self.order < 2:
            raise ValueError("order must be >= 2")
        if self.factor_num < 1:
            raise ValueError(f"factor_num must be >= 1, got {self.factor_num}")
        if self.vocabulary_size <= 0:
            raise ValueError("vocabulary_size must be positive")
        if self.vocabulary_size > 2**31 - 1:
            raise ValueError(
                f"vocabulary_size {self.vocabulary_size} exceeds int32 "
                "(2**31 - 1), the device feature-id dtype"
            )
        if self.table_layout not in ("rows", "packed"):
            raise ValueError(f"unknown table_layout {self.table_layout!r} (rows | packed)")
        if self.table_layout == "packed":
            raise ValueError(
                "table_layout = packed is not ported yet (the packed and fused "
                "layouts are a later slice of fast_tffm_tpu_torch); use rows"
            )
        if self.checkpoint_format not in ("npz", "orbax"):
            raise ValueError(f"unknown checkpoint_format {self.checkpoint_format!r}")
        if self.checkpoint_format == "orbax":
            raise ValueError(
                "checkpoint_format = orbax is not ported yet (sharded "
                "checkpoints are a later slice of fast_tffm_tpu_torch); use npz"
            )
        if self.max_nnz < 0:
            raise ValueError(f"max_nnz must be >= 0, got {self.max_nnz}")
        if self.wire_format not in ("packed", "arrays"):
            raise ValueError(f"unknown wire_format {self.wire_format!r} (packed | arrays)")
        self.serve_buckets = validate_buckets(self.serve_buckets)
        if self.serve_max_batch < 0:
            raise ValueError(
                f"serve_max_batch must be >= 0 (0 = largest bucket), got {self.serve_max_batch}"
            )
        if self.serve_max_batch > self.serve_buckets[-1]:
            raise ValueError(
                f"serve_max_batch {self.serve_max_batch} exceeds the largest "
                f"bucket {self.serve_buckets[-1]}"
            )
        if self.serve_flush_deadline_ms < 0:
            raise ValueError(
                f"serve_flush_deadline_ms must be >= 0, got {self.serve_flush_deadline_ms}"
            )
        if self.serve_queue_size < 1:
            raise ValueError(f"serve_queue_size must be >= 1, got {self.serve_queue_size}")
        if self.serve_overload not in ("block", "reject"):
            raise ValueError(f"unknown serve_overload {self.serve_overload!r} (block | reject)")
        if self.serve_reload_interval_s < 0:
            raise ValueError("serve_reload_interval_s must be >= 0")
        if not (0 <= self.serve_port <= 65535):
            raise ValueError(f"serve_port must be in [0, 65535], got {self.serve_port}")
        if self.serve_deadline_ms < 0:
            raise ValueError(
                f"serve_deadline_ms must be >= 0 (0 = none), got {self.serve_deadline_ms}"
            )
        self.serve_classes = validate_classes(self.serve_classes)
        return self


def validate_buckets(buckets) -> tuple[int, ...]:
    """Normalize a serve_buckets spec: positive ints, sorted, deduped, non-empty."""
    try:
        out = tuple(sorted({int(b) for b in buckets}))
    except (TypeError, ValueError) as e:
        raise ValueError(f"serve_buckets must be integers, got {buckets!r}") from e
    if not out or out[0] < 1:
        raise ValueError(f"serve_buckets must be positive and non-empty, got {buckets!r}")
    return out


def validate_classes(classes) -> tuple[tuple[str, int], ...]:
    """Normalize a serve_classes spec: a ``"gold:2,std:1"`` string or an
    iterable of (name, tier) pairs → sorted tuple of (name, tier)."""
    if isinstance(classes, str):
        pairs = []
        for tok in _split(classes):
            name, sep, tier = tok.partition(":")
            if not sep or not name:
                raise ValueError(f"serve_classes entries are name:tier, got {tok!r}")
            pairs.append((name, tier))
        classes = pairs
    out = []
    try:
        for name, tier in classes:
            name, tier = str(name), int(tier)
            if not name or tier < 0:
                raise ValueError
            out.append((name, tier))
    except (TypeError, ValueError):
        raise ValueError(
            f"serve_classes must be name:tier pairs with tier >= 0, got {classes!r}"
        ) from None
    seen = set()
    for name, _ in out:
        if name in seen:
            raise ValueError(f"duplicate serve_classes name {name!r}")
        seen.add(name)
    return tuple(sorted(out))


def _split(s: str) -> tuple[str, ...]:
    return tuple(x for x in (t.strip() for t in s.replace(",", " ").split()) if x)


def _split_files(s: str) -> tuple[str, ...]:
    """File list with sorted glob expansion; a pattern with no match is kept
    literally so the missing-file error names the user's path."""
    out: list[str] = []
    for tok in _split(s):
        if any(c in tok for c in "*?["):
            out.extend(sorted(glob.glob(tok)) or [tok])
        else:
            out.append(tok)
    return tuple(out)


def load_config(path: str) -> Config:
    """Parse an INI file into a validated Config."""
    # "key = value  ; comment" annotations must not leak into values.
    ini = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    with open(path) as f:
        ini.read_file(f)
    cfg = Config()

    def get(section, key, conv, default):
        if ini.has_option(section, key):
            return conv(ini.get(section, key))
        return default

    boolean = ini._convert_to_boolean
    g = "General"
    cfg.model = get(g, "model", str, cfg.model).lower()
    cfg.factor_num = get(g, "factor_num", int, cfg.factor_num)
    cfg.order = get(g, "order", int, cfg.order)
    cfg.vocabulary_size = get(g, "vocabulary_size", int, cfg.vocabulary_size)
    cfg.hash_feature_id = get(g, "hash_feature_id", boolean, cfg.hash_feature_id)
    cfg.table_layout = get(g, "table_layout", str, cfg.table_layout).lower()
    cfg.model_file = get(g, "model_file", str, cfg.model_file)
    cfg.checkpoint_format = get(g, "checkpoint_format", str, cfg.checkpoint_format).lower()

    t = "Train"
    cfg.train_files = get(t, "train_files", _split_files, cfg.train_files)
    cfg.validation_files = get(t, "validation_files", _split_files, cfg.validation_files)
    cfg.max_nnz = get(t, "max_nnz", int, cfg.max_nnz)
    cfg.init_value_range = get(t, "init_value_range", float, cfg.init_value_range)
    cfg.wire_format = get(t, "wire_format", str, cfg.wire_format).lower()

    p = "Predict"
    cfg.predict_files = get(p, "predict_files", _split_files, cfg.predict_files)

    s = "Serving"
    cfg.serve_buckets = get(
        s, "buckets", lambda v: tuple(int(x) for x in _split(v)), cfg.serve_buckets
    )
    cfg.serve_max_batch = get(s, "max_batch", int, cfg.serve_max_batch)
    cfg.serve_flush_deadline_ms = get(
        s, "flush_deadline_ms", float, cfg.serve_flush_deadline_ms
    )
    cfg.serve_queue_size = get(s, "queue_size", int, cfg.serve_queue_size)
    cfg.serve_overload = get(s, "overload", str, cfg.serve_overload).lower()
    cfg.serve_reload_interval_s = get(
        s, "reload_interval_s", float, cfg.serve_reload_interval_s
    )
    cfg.serve_port = get(s, "port", int, cfg.serve_port)
    cfg.serve_deadline_ms = get(s, "deadline_ms", float, cfg.serve_deadline_ms)
    cfg.serve_classes = get(s, "classes", str, cfg.serve_classes)
    return cfg.validate()


def build_model(cfg: Config):
    """Instantiate the configured model (FM only in this slice)."""
    from fast_tffm_tpu_torch.models.fm import FMModel

    return FMModel(
        vocabulary_size=cfg.vocabulary_size,
        factor_num=cfg.factor_num,
        order=cfg.order,
        init_value_range=cfg.init_value_range,
    )
