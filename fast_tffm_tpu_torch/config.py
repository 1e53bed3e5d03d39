"""INI config for the port: the JAX package's key vocabulary, cut to the
ported paths (training, offline prediction, serving).

A copy of ``fast_tffm_tpu/config.py`` reduced to what those paths read.
It parses the same files (``sample.cfg``, ``configs/*.cfg``) with the same
sections, keys and defaults; keys it does not model are ignored, as they
are by ``ConfigParser`` reads of absent options.  Configurations this port
cannot run yet are refused with a ``ValueError`` that names the later
slice, never run differently: by ``Config.validate`` where no verb could
run them, else by the entry point that would read the setting
(``refuse_later_slices``).
"""

from __future__ import annotations

import configparser
import dataclasses
import glob

__all__ = [
    "Config",
    "load_config",
    "validate_buckets",
    "validate_classes",
    "refuse_later_slices",
    "build_model",
]


@dataclasses.dataclass
class Config:
    # [General]
    model: str = "fm"  # fm (ffm | deepfm are later slices of the port)
    factor_num: int = 8
    order: int = 2
    vocabulary_size: int = 1 << 20
    hash_feature_id: bool = False
    table_layout: str = "rows"  # rows ([V, D]) | packed (lane-packed tile
    #   rows, ops/packed_table.py; train runs it with adagrad_accumulator =
    #   fused, predict and serve with any accumulator)
    model_file: str = "model.ckpt"
    checkpoint_format: str = "npz"  # npz (orbax is a later slice)
    # [Checkpoint] — read so they can be refused (async/delta saves are a
    #   later slice)
    async_save: bool = False
    delta_every_steps: int = 0
    # [Train]
    train_files: tuple[str, ...] = ()
    weight_files: tuple[float, ...] = ()  # per-file example weights
    validation_files: tuple[str, ...] = ()
    epoch_num: int = 1
    batch_size: int = 1024
    max_nnz: int = 0  # 0 = infer from a scan of the data files
    learning_rate: float = 0.01
    init_value_range: float = 0.01
    factor_lambda: float = 0.0
    bias_lambda: float = 0.0
    init_accumulator_value: float = 0.1
    adagrad_accumulator: str = "element"  # element | row | fused (row
    #   semantics, the accumulator stored in the packed table's own tile
    #   rows; requires table_layout = packed)
    packed_compact_cap: int = 0  # the fused tail's deduped-row cap (read and
    #   passed through: the port's tail always visits exactly the K rows)
    packed_update: str = "auto"  # packed sparse tail: auto | dense | compact |
    #   sorted (JAX compiler paths; the port's fused tail is always kernel B3)
    tail: str = "auto"  # sparse Adagrad tail: auto | xla | pallas.  On the
    #   card every value runs the layout's Adagrad kernel (csrc/
    #   rows_tail_adagrad.cu or csrc/fused_tail_adagrad.cu; xla names a JAX
    #   compiler path the port does not have, and says so in the log); on
    #   the CPU its plain twin
    thread_num: int = 0  # read for parity; the port parses in one thread
    binary_cache: bool = False  # read to be refused (a later slice)
    shuffle: bool = False  # read to be refused (FMB input, a later slice)
    device_cache: bool = False  # read to be refused (a later slice)
    steps_per_call: int = 1  # read to be refused when > 1 (a later slice)
    dedup_gather_rows: int = 0  # read to be refused when > 0 (a later slice)
    wire_format: str = "packed"  # read for parity; the port always stages
    #   one pinned host->device buffer per flush (serving/buckets.py), and
    #   the packed wire (data/wire.py) changes no value
    queue_size: int = 8  # prefetch depth
    log_every: int = 100
    save_every_epochs: int = 1
    trace_dir: str = ""  # read to be refused when set (a later slice)
    metrics_path: str = ""  # read to be refused when set (a later slice)
    # [Telemetry]
    telemetry_profile_steps: str = ""  # read to be refused when set
    # [Predict]
    predict_files: tuple[str, ...] = ()
    score_path: str = "scores.txt"
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
    # [Online]
    online_follow: bool = False  # read to be refused (a later slice)
    online_adagrad_decay: float = 1.0  # γ: lazy touched-row accumulator decay
    online_accum_restart_steps: int = 0  # read to be refused (a later slice)
    # [ParamStore]
    paramstore: bool = False  # read to be refused (a later slice)
    # [Resilience]
    on_nan: str = "abort"  # abort (rollback: a later slice)

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
        self._validate_train()
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

    def _validate_train(self) -> None:
        """The JAX checks of the [Train]/[Online]/[Resilience] keys, for
        every verb as in the JAX package.  The settings whose paths are
        later slices are refused by the entry points that would read them
        (``training.train``, ``prediction.predict``), so serving still
        takes a config written for training."""
        if self.batch_size <= 0:
            raise ValueError("vocabulary_size and batch_size must be positive")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.thread_num < 0:
            raise ValueError(f"thread_num must be >= 0 (0 = all cores), got {self.thread_num}")
        if self.adagrad_accumulator not in ("element", "row", "fused"):
            raise ValueError(
                f"unknown adagrad_accumulator {self.adagrad_accumulator!r} "
                "(element | row | fused)"
            )
        if self.packed_compact_cap < 0:
            raise ValueError(f"packed_compact_cap must be >= 0, got {self.packed_compact_cap}")
        if self.packed_compact_cap > 0 and self.adagrad_accumulator != "fused":
            raise ValueError(
                "packed_compact_cap > 0 requires adagrad_accumulator = fused "
                "(it sizes the fused compact tail's row buffer)"
            )
        if self.adagrad_accumulator == "fused" and self.table_layout != "packed":
            # Fused is a physical layout: the row accumulator stored in the
            # table's own tile rows, which only the packed layout has.
            raise ValueError("adagrad_accumulator = fused requires table_layout = packed")
        if self.init_accumulator_value <= 0:
            # A zero accumulator makes the first update of an element with
            # zero summed gradient compute 0/sqrt(0) = NaN.
            raise ValueError(
                f"init_accumulator_value must be > 0, got {self.init_accumulator_value}"
            )
        if self.tail not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown tail {self.tail!r} (auto | xla | pallas)")
        if not (0.0 < self.online_adagrad_decay <= 1.0):
            raise ValueError(
                f"[Online] adagrad_decay must be in (0, 1], got {self.online_adagrad_decay}"
            )
        if self.online_adagrad_decay != 1.0 and self.table_layout != "rows":
            # The packed tile-row updates rely on the zero-grad accumulator
            # identity; a lane-blind decay would break it.
            raise ValueError("[Online] adagrad_decay < 1 requires table_layout = rows")
        if self.online_accum_restart_steps < 0:
            raise ValueError(
                f"[Online] accum_restart_steps must be >= 0, got "
                f"{self.online_accum_restart_steps}"
            )
        if self.online_accum_restart_steps > 0 and self.adagrad_accumulator == "fused":
            raise ValueError(
                "[Online] accum_restart_steps requires adagrad_accumulator "
                "= element or row (the fused layout has no separate "
                "accumulator array to reset)"
            )
        if self.dedup_gather_rows < 0:
            raise ValueError(
                f"dedup_gather_rows must be >= 0 (0 = off), got {self.dedup_gather_rows}"
            )
        if self.delta_every_steps < 0:
            raise ValueError(
                f"delta_every_steps must be >= 0 (0 = off), got {self.delta_every_steps}"
            )
        if self.on_nan not in ("abort", "rollback"):
            raise ValueError(f"unknown on_nan {self.on_nan!r} (abort | rollback)")
        if self.packed_update not in ("auto", "dense", "compact", "sorted"):
            raise ValueError(
                f"unknown packed_update {self.packed_update!r} (auto | dense | compact | sorted)"
            )
        if self.packed_update != "auto" and self.table_layout != "packed":
            raise ValueError(
                f"packed_update = {self.packed_update} requires table_layout = "
                "packed (it selects the packed layout's sparse-tail strategy)"
            )
        if (
            self.table_layout == "packed"
            and self.adagrad_accumulator in ("row", "fused")
            and self.packed_update == "sorted"
        ):
            raise ValueError(
                "table_layout = packed with adagrad_accumulator = row requires "
                "packed_update = auto, dense or compact (the sorted "
                "whole-tile-row RMW needs the element accumulator)"
            )
        if (
            self.tail == "pallas"
            and self.table_layout == "packed"
            and self.adagrad_accumulator != "fused"
        ):
            raise ValueError(
                "tail = pallas with table_layout = packed requires "
                "adagrad_accumulator = fused (the kernel updates the merged "
                "fused layout's D+1-lane slots in one pass)"
            )


def refuse_later_slices(verb: str, refusals) -> None:
    """Raise for the first ``(refused, what)`` pair that holds: a setting
    whose path the port's ``verb`` does not run yet.  Each entry point
    lists the settings it would read; the others never reach it."""
    for refused, what in refusals:
        if refused:
            raise ValueError(
                f"{what} is not ported yet for {verb} (a later slice of "
                "fast_tffm_tpu_torch); use fast_tffm_tpu"
            )


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
    cfg.weight_files = get(
        t, "weight_files", lambda s: tuple(float(x) for x in _split(s)), cfg.weight_files
    )
    cfg.validation_files = get(t, "validation_files", _split_files, cfg.validation_files)
    cfg.epoch_num = get(t, "epoch_num", int, cfg.epoch_num)
    cfg.batch_size = get(t, "batch_size", int, cfg.batch_size)
    cfg.max_nnz = get(t, "max_nnz", int, cfg.max_nnz)
    cfg.learning_rate = get(t, "learning_rate", float, cfg.learning_rate)
    cfg.init_value_range = get(t, "init_value_range", float, cfg.init_value_range)
    cfg.factor_lambda = get(t, "factor_lambda", float, cfg.factor_lambda)
    cfg.bias_lambda = get(t, "bias_lambda", float, cfg.bias_lambda)
    cfg.init_accumulator_value = get(
        t, "init_accumulator_value", float, cfg.init_accumulator_value
    )
    cfg.adagrad_accumulator = get(t, "adagrad_accumulator", str, cfg.adagrad_accumulator).lower()
    cfg.packed_update = get(t, "packed_update", str, cfg.packed_update).lower()
    cfg.packed_compact_cap = get(t, "packed_compact_cap", int, cfg.packed_compact_cap)
    cfg.tail = get(t, "tail", str, cfg.tail).lower()
    cfg.thread_num = get(t, "thread_num", int, cfg.thread_num)
    cfg.binary_cache = get(t, "binary_cache", boolean, cfg.binary_cache)
    cfg.shuffle = get(t, "shuffle", boolean, cfg.shuffle)
    cfg.device_cache = get(t, "device_cache", boolean, cfg.device_cache)
    cfg.dedup_gather_rows = get(t, "dedup_gather_rows", int, cfg.dedup_gather_rows)
    cfg.steps_per_call = get(t, "steps_per_call", int, cfg.steps_per_call)
    cfg.wire_format = get(t, "wire_format", str, cfg.wire_format).lower()
    cfg.queue_size = get(t, "queue_size", int, cfg.queue_size)
    cfg.log_every = get(t, "log_every", int, cfg.log_every)
    cfg.save_every_epochs = get(t, "save_every_epochs", int, cfg.save_every_epochs)
    cfg.trace_dir = get(t, "trace_dir", str, cfg.trace_dir)
    cfg.metrics_path = get(t, "metrics_path", str, cfg.metrics_path)

    cfg.telemetry_profile_steps = get(
        "Telemetry", "profile_steps", str, cfg.telemetry_profile_steps
    )
    c = "Checkpoint"
    cfg.async_save = get(c, "async_save", boolean, cfg.async_save)
    cfg.delta_every_steps = get(c, "delta_every_steps", int, cfg.delta_every_steps)

    p = "Predict"
    cfg.predict_files = get(p, "predict_files", _split_files, cfg.predict_files)
    cfg.score_path = get(p, "score_path", str, cfg.score_path)

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

    o = "Online"
    cfg.online_follow = get(o, "follow", boolean, cfg.online_follow)
    cfg.online_adagrad_decay = get(o, "adagrad_decay", float, cfg.online_adagrad_decay)
    cfg.online_accum_restart_steps = get(
        o, "accum_restart_steps", int, cfg.online_accum_restart_steps
    )
    cfg.paramstore = get("ParamStore", "enabled", boolean, cfg.paramstore)
    cfg.on_nan = get("Resilience", "on_nan", str, cfg.on_nan).lower()
    return cfg.validate()


def build_model(cfg: Config):
    """Instantiate the configured model (FM only in this slice)."""
    from fast_tffm_tpu_torch.models.fm import FMModel

    return FMModel(
        vocabulary_size=cfg.vocabulary_size,
        factor_num=cfg.factor_num,
        order=cfg.order,
        init_value_range=cfg.init_value_range,
        factor_lambda=cfg.factor_lambda,
        bias_lambda=cfg.bias_lambda,
    )
