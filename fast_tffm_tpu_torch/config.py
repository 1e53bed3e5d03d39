"""INI config for the port: the JAX package's key vocabulary.

A copy of ``fast_tffm_tpu/config.py``: it parses the same files
(``sample.cfg``, ``configs/*.cfg``) with the same sections, keys, defaults
and checks, ``[Distributed]`` included, and reads every key the JAX
package reads.  ``Config.validate`` refuses what the JAX package refuses,
in its words.  Beyond it, the port has one model of its own, ``dcnv2``
(DCN-V2, ``models/dcnv2.py``), and its two keys (``PORT_ONLY_KEYS``),
which the JAX package neither reads nor refuses.
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
    "build_model",
    "check_deepfm_width",
    "MODELS",
    "PORT_ONLY_KEYS",
    "jax_fields",
]

MODELS = ("fm", "ffm", "deepfm", "dcnv2")
# The Config fields of the port alone (dcnv2's), at their defaults for every
# other model; the JAX package's Config has none of them.
PORT_ONLY_KEYS = ("cross_layers", "cross_rank")


@dataclasses.dataclass
class Config:
    # [General]
    model: str = "fm"  # fm | ffm | deepfm | dcnv2 (the port's alone)
    factor_num: int = 8
    order: int = 2
    num_fields: int = 0  # required for ffm/deepfm/dcnv2
    hidden_dims: tuple[int, ...] = (400, 400, 400)  # deepfm MLP head; dcnv2's top MLP
    compute_dtype: str = "float32"  # deepfm and dcnv2 matmuls and ffm interaction
    #   einsums: float32 | bfloat16 (operands rounded to bfloat16, products
    #   accumulated in float32, float32 master weights)
    cross_layers: int = 3  # dcnv2: low-rank cross layers
    cross_rank: int = 512  # dcnv2: each cross layer's rank
    vocabulary_size: int = 1 << 20
    vocabulary_block_num: int = 1  # the reference's key; row_parallel's default
    hash_feature_id: bool = False
    table_layout: str = "rows"  # rows ([V, D]) | packed (lane-packed tile
    #   rows, ops/packed_table.py; with any adagrad_accumulator)
    model_file: str = "model.ckpt"
    checkpoint_format: str = "npz"  # npz | orbax (orbax = sharded, per-process writes)
    # [Checkpoint] (checkpoint_async.AsyncCheckpointer)
    async_save: bool = False  # full saves off the train loop: a device
    #   snapshot at the boundary, a writer thread does the D2H and the
    #   write; at most one in flight; the stop and final saves stay
    #   synchronous
    delta_every_steps: int = 0  # > 0: between full saves, a delta-NNNN file
    #   every N steps with only the rows the window touched + dense leaves,
    #   chained to the base by content signature; 0 = off
    delta_chain_max: int = 16  # deltas per chain before a delta boundary
    #   promotes itself to a full save
    delta_full_every_s: float = 0.0  # [Checkpoint] full_every_s: promote to a
    #   full save once this many seconds passed since the last one (0 = off)
    delta_chain_max_bytes: int = 0  # [Checkpoint] chain_max_bytes: promote
    #   once the chain's delta files total this many bytes (0 = off)
    checkpoint_chunk_mb: int = 64  # save/restore host staging: arrays move
    #   device->host and to disk this many MB at a time
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
    #   sorted (JAX compiler paths; the port's packed tails are always kernel
    #   B4 at the packed address or, fused, kernel B3)
    tail: str = "auto"  # sparse Adagrad tail: auto | xla | pallas.  On the
    #   card every value runs the layout's Adagrad kernel (csrc/
    #   rows_tail_adagrad.cu or csrc/fused_tail_adagrad.cu; xla names a JAX
    #   compiler path the port does not have, and says so in the log); on
    #   the CPU its plain twin
    thread_num: int = 0  # the native C++ parser's threads (data/native.py;
    #   0 = all usable cores): every text stream of train, validation and
    #   predict parses through it
    binary_cache: bool = False  # parse text once into <file>.fmb, stream that
    binary_cache_wait: float = 600.0  # multi-process: how long a non-lead rank
    #   waits for the lead's cache build before building its own (s)
    shuffle: bool = False  # per-epoch global shuffle of train rows (FMB input only)
    shuffle_seed: int = 0
    device_cache: bool = False  # the (FMB) train set resident on the device,
    #   each step's batch gathered there (data/device_cache.py)
    steps_per_call: int = 1  # K train steps per call: on the card one replay
    #   of a CUDA graph of K steps (utils/step_graph.py), on the CPU a loop
    dedup_gather_rows: int = 0  # > 0 (streamed rows layout): each batch's
    #   unique ids checked against the cap before it ships; the step gathers
    #   directly (the JAX package's dedup gather gives the same values)
    wire_format: str = "packed"  # streamed FMB input at steps_per_call > 1:
    #   packed (each K-group in ONE byte buffer, data/wire.py: one pinned
    #   host->device copy and an unpack on the device, in a second prefetch
    #   thread) | arrays (one copy per tensor, in the loop); the values are
    #   the same either way.  At K = 1 the port ships arrays under either:
    #   the eager step's loop is Python-bound and a converting thread takes
    #   its interpreter time (PERF.md).  The tiered store always
    #   ships on the packed wire.
    queue_size: int = 8  # prefetch depth
    log_every: int = 100
    save_every_epochs: int = 1
    trace_dir: str = ""  # torch.profiler Chrome traces of a step window
    trace_steps: int = 20  # that window's length (after 5 warm-up steps)
    metrics_path: str = ""  # JSONL telemetry sink (telemetry.SCHEMAS records,
    #   read by tools/report.py)
    # [Telemetry] (telemetry.RunMonitor, profiling.py)
    telemetry_run_id: str = ""  # envelope run id; empty = generated
    telemetry_mem_every_s: float = 30.0  # kind=mem cadence (0 = the final
    #   record only)
    telemetry_stall_timeout_s: float = 0.0  # watchdog deadline (0 = off)
    telemetry_compilation_cache_dir: str = ""  # the JAX package's XLA cache;
    #   the port logs a note (its kernels are cached in _build/)
    telemetry_profile_steps: str = ""  # "A:B": a torch.profiler trace over
    #   steps [A, B) into <model_file>.profile (trace_dir overrides)
    telemetry_profile_costs: bool = True  # one kind=profile record per step
    #   program (examples, modeled HBM floor; no compiler cost numbers)
    telemetry_datastats_every_steps: int = 0  # kind=datastats id statistics
    #   every N steps (0 = off)
    telemetry_heavy_hitter_k: int = 16  # top-K buckets of that sketch
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
    serve_reload_interval_s: float = 0.0  # hot reload poll of model_file: a
    #   changed checkpoint (full save or new delta files) is staged off the
    #   hot path and swapped in between flushes (0 = no watcher)
    serve_reload_max_retries: int = 8  # consecutive reload failures on one
    #   checkpoint signature before the engine gives up on it until a new
    #   write lands (retries back off exponentially from the poll interval)
    serve_port: int = 0  # socket front end (serving/frontend.py); 0 = pipe
    #   mode unless the CLI passes --port (0 there = ephemeral, announced)
    serve_replicas: int = 1  # replica worker processes behind the router,
    #   each owning one engine on the device
    serve_deadline_ms: float = 0.0  # default per-request deadline; 0 = none
    serve_metrics_every_s: float = 10.0  # kind=serving record cadence
    serve_classes: tuple[tuple[str, int], ...] = ()  # class -> admission tier
    serve_wire: str = "binary"  # data wire a client may negotiate by hello:
    #   binary (DATA frames, JSONL the fallback) | jsonl (no upgrade)
    serve_affinity: bool = True  # hello hands the client a healthy replica's
    #   port; the replica answers its frames directly
    # [Online]
    online_follow: bool = False  # follow the one FMS train file: at EOF the
    #   reader polls for growth instead of ending the epoch (data/stream.py;
    #   train only, epoch_num = 1)
    online_poll_s: float = 0.2  # the EOF poll interval (seconds)
    online_idle_timeout_s: float = 0.0  # > 0: end the stream after this much
    #   continuous writer silence; 0 = follow until the process is stopped
    online_max_batches: int = 0  # > 0: end the stream once the batch index,
    #   resume-skipped batches included, reaches N; 0 = unbounded
    online_adagrad_decay: float = 1.0  # γ: lazy touched-row accumulator decay
    online_accum_restart_steps: int = 0  # every N steps (K-aligned, absolute
    #   multiples) reset every accumulator to init_accumulator_value; 0 = off
    # [ParamStore] (paramstore/): a table beyond the card's memory — a compact
    # [hot_rows + miss_rows, D] table on the device, the full logical table
    # in memmap files on the host; the prefetch thread resolves each batch's
    # ids and its missed rows ride the batch's one host->device buffer
    paramstore: bool = False  # enable the tiered store (train only;
    #   table_layout = rows, npz checkpoints)
    paramstore_hot_rows: int = 4096  # device-resident hot rows
    paramstore_miss_rows: int = 0  # staging rows for one call's unique
    #   non-resident ids; 0 = auto (batch_size * max_nnz * steps_per_call,
    #   which no call can overflow); a smaller cap fails loudly when a call
    #   needs more
    paramstore_dir: str = ""  # cold-store directory; "" = <model_file>.store
    paramstore_residency: str = "sample"  # hot-set policy: sample (exact
    #   frequency count over the first sample_batches train batches, top
    #   hot_rows) | first (ids [0, hot_rows)) | file:PATH (.npy or one id a
    #   line; the first hot_rows distinct ids)
    paramstore_sample_batches: int = 8  # batches the sample policy counts
    paramstore_materialize: str = "auto"  # cold-store init: auto (this
    #   package's init draw written into the store up to 2^21 rows, so a
    #   tiered run is bitwise the resident run; hashed per-row init beyond)
    #   | always | never
    # [Resilience]
    on_nan: str = "abort"  # abort (raise before the next save) | rollback
    #   (restore the last checkpoint, skip the diverged window's input)
    max_rollbacks: int = 2  # rollback budget per run; exhausted -> abort
    io_retries: int = 3  # FMB reader: transient-OSError retries per read op
    io_retry_backoff_s: float = 0.05  # first retry backoff (doubles per try)
    restart_max: int = 5  # the serving router's replica restarts (bounded)
    restart_backoff_s: float = 1.0  # restart backoff base (doubles)
    restart_backoff_max_s: float = 30.0  # restart backoff cap
    # [Distributed] (dist_train / dist_predict: one rank per process and
    # device, parallel/mesh.py)
    data_parallel: int = 0  # 0 = the ranks left after row_parallel
    row_parallel: int = 0  # 0 = vocabulary_block_num
    lookup: str = "allgather"  # the embedding lookup's collective (| alltoall)
    lookup_capacity_factor: float = 2.0  # alltoall per-destination slack
    lookup_overflow: str = "fallback"  # fallback (the step through allgather)
    #   | abort (the loss goes NaN before any save)
    coordinator_address: str = ""  # host:port of rank 0's store (tcp://)
    num_processes: int = 0  # ranks in the run (world size); <= 1: no group
    process_id: int = -1  # this process's rank
    input_assignment: str = "rows"  # streamed input split: rows (block-cyclic
    #   line sharding of every file) | files (rank p streams files [p::P]
    #   whole; short ranks pad the epoch tail with weight-0 batches)
    runtime_dir: str = ""  # shared coordination dir (the file KV, the
    #   heartbeats, a pod's generation file; dist_train --supervised
    #   defaults it to <model_file>.dist)
    heartbeat_s: float = 2.0  # per-host heartbeat cadence (pod supervision)
    host_stall_timeout_s: float = 0.0  # peer-heartbeat staleness: > 0 arms
    #   the peer monitor's kind=stall records and the supervisor's straggler kill
    barrier_timeout_s: float = 120.0  # cross-process barrier / signature /
    #   cursor-gather wait budget; a timeout means a peer is gone

    def validate(self) -> "Config":
        if self.model not in MODELS:
            raise ValueError(f"unknown model {self.model!r}")
        if self.model in ("ffm", "deepfm", "dcnv2") and self.num_fields <= 0:
            raise ValueError(f"{self.model} requires num_fields > 0")
        if self.model == "dcnv2" and (self.cross_layers < 1 or self.cross_rank < 1):
            raise ValueError(f"dcnv2 requires cross_layers >= 1 and cross_rank >= 1, got "
                             f"{self.cross_layers} and {self.cross_rank}")
        if self.model == "fm" and self.order < 2:
            raise ValueError("order must be >= 2")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        self.check_width(self.max_nnz)
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
        if self.max_nnz < 0:
            raise ValueError(f"max_nnz must be >= 0, got {self.max_nnz}")
        if self.wire_format not in ("packed", "arrays"):
            raise ValueError(f"unknown wire_format {self.wire_format!r} (packed | arrays)")
        self._validate_train()
        self._validate_distributed()
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
        if self.serve_reload_interval_s < 0 or self.serve_metrics_every_s < 0:
            raise ValueError("serve_reload_interval_s and serve_metrics_every_s must be >= 0")
        if self.serve_reload_max_retries < 1:
            raise ValueError(
                f"serve_reload_max_retries must be >= 1, got {self.serve_reload_max_retries}"
            )
        if not (0 <= self.serve_port <= 65535):
            raise ValueError(f"serve_port must be in [0, 65535], got {self.serve_port}")
        if self.serve_replicas < 1:
            raise ValueError(f"serve_replicas must be >= 1, got {self.serve_replicas}")
        if self.serve_deadline_ms < 0:
            raise ValueError(
                f"serve_deadline_ms must be >= 0 (0 = none), got {self.serve_deadline_ms}"
            )
        self.serve_classes = validate_classes(self.serve_classes)
        if self.serve_wire not in ("binary", "jsonl"):
            raise ValueError(f"unknown serve_wire {self.serve_wire!r} (binary | jsonl)")
        return self

    def _validate_paramstore(self) -> None:
        """The JAX checks of ``[ParamStore]``, in its order and words."""
        if self.table_layout != "rows":
            raise ValueError(
                "[ParamStore] requires table_layout = rows (the "
                "compact device tier is a plain [C, D] table)"
            )
        if self.checkpoint_format != "npz":
            raise ValueError(
                "[ParamStore] requires checkpoint_format = npz (both "
                "tiers publish through the npz chain)"
            )
        if self.device_cache:
            raise ValueError(
                "[ParamStore] and device_cache are exclusive: the "
                "tiered store IS the residency decision"
            )
        if self.online_follow:
            raise ValueError(
                "[ParamStore] with [Online] follow is not supported "
                "yet (ROADMAP item 4 composes them)"
            )
        if self.async_save:
            raise ValueError(
                "[ParamStore] saves are synchronous (the post-publish "
                "store apply must order after the npz publish) — drop "
                "async_save"
            )
        if self.adagrad_accumulator == "fused":
            raise ValueError(
                "[ParamStore] supports adagrad_accumulator = element "
                "or row (fused is a packed-layout storage choice)"
            )
        if self.on_nan == "rollback":
            raise ValueError(
                "[ParamStore] with on_nan = rollback is not supported "
                "yet — use abort (the tiered restore path does not "
                "plug into the in-process rollback loop)"
            )
        if self.online_accum_restart_steps > 0:
            raise ValueError(
                "[ParamStore] cannot combine with accum_restart_steps: "
                "a global accumulator reset cannot reach the cold "
                "tier's rows — use adagrad_decay"
            )
        if self.paramstore_hot_rows < 1:
            raise ValueError(
                f"[ParamStore] hot_rows must be >= 1, got {self.paramstore_hot_rows}"
            )
        if self.paramstore_miss_rows < 0:
            raise ValueError(
                "[ParamStore] miss_rows must be >= 0 (0 = auto), got "
                f"{self.paramstore_miss_rows}"
            )
        if self.paramstore_sample_batches < 1:
            raise ValueError(
                "[ParamStore] sample_batches must be >= 1, got "
                f"{self.paramstore_sample_batches}"
            )
        if self.paramstore_residency not in ("sample", "first") and not (
            self.paramstore_residency.startswith("file:") and len(self.paramstore_residency) > 5
        ):
            raise ValueError(
                f"unknown [ParamStore] residency {self.paramstore_residency!r} "
                "(sample | first | file:PATH)"
            )
        if self.paramstore_materialize not in ("auto", "always", "never"):
            raise ValueError(
                f"unknown [ParamStore] materialize {self.paramstore_materialize!r} "
                "(auto | always | never)"
            )

    def _validate_distributed(self) -> None:
        """The JAX checks of the ``[Distributed]`` keys, in its words."""
        if self.lookup not in ("allgather", "alltoall"):
            raise ValueError(f"unknown lookup {self.lookup!r} (allgather | alltoall)")
        if self.lookup_overflow not in ("fallback", "abort"):
            raise ValueError(
                f"unknown lookup_overflow {self.lookup_overflow!r} (fallback | abort)"
            )
        if self.input_assignment not in ("rows", "files"):
            raise ValueError(
                f"unknown input_assignment {self.input_assignment!r} (rows | files)"
            )
        if self.heartbeat_s <= 0:
            raise ValueError(f"heartbeat_s must be > 0, got {self.heartbeat_s}")
        if self.host_stall_timeout_s < 0:
            raise ValueError(
                f"host_stall_timeout_s must be >= 0 (0 = off), got "
                f"{self.host_stall_timeout_s}"
            )
        if self.barrier_timeout_s <= 0:
            raise ValueError(f"barrier_timeout_s must be > 0, got {self.barrier_timeout_s}")

    def check_width(self, max_nnz: int) -> None:
        """Refuse a slot width the model cannot take (DeepFM and DCN-V2:
        max_nnz must be num_fields).  The entry points call it again with the
        width they infer when ``max_nnz`` is 0."""
        if self.model in ("deepfm", "dcnv2"):
            check_deepfm_width(self.num_fields, max_nnz, self.model)

    def _validate_train(self) -> None:
        """The JAX checks of the [Train]/[Online]/[ParamStore]/[Resilience]
        keys, for every verb as in the JAX package."""
        if self.batch_size <= 0:
            raise ValueError("vocabulary_size and batch_size must be positive")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if self.thread_num < 0:
            raise ValueError(f"thread_num must be >= 0 (0 = all cores), got {self.thread_num}")
        if self.shuffle_seed < 0:
            # numpy's SeedSequence rejects negatives: fail at the config.
            raise ValueError(f"shuffle_seed must be >= 0, got {self.shuffle_seed}")
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
        if self.online_poll_s <= 0:
            raise ValueError(f"[Online] poll_s must be > 0, got {self.online_poll_s}")
        if self.online_idle_timeout_s < 0 or self.online_max_batches < 0:
            raise ValueError(
                "[Online] idle_timeout_s and max_batches must be >= 0 (0 = off)"
            )
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
        if self.online_accum_restart_steps > 0 and self.online_adagrad_decay != 1.0:
            # Two forgetting mechanisms at once make every A/B ambiguous.
            raise ValueError(
                "[Online] adagrad_decay < 1 and accum_restart_steps > 0 are "
                "exclusive — choose one forgetting mechanism"
            )
        if self.online_follow and self.shuffle:
            raise ValueError(
                "[Online] follow = true cannot shuffle: an append-only "
                "stream has no fixed row count to permute"
            )
        if self.online_follow and self.device_cache:
            raise ValueError(
                "[Online] follow = true is a streamed input mode — "
                "device_cache loads a FIXED dataset to HBM once"
            )
        if self.online_follow and self.epoch_num != 1:
            raise ValueError(
                "[Online] follow = true runs ONE endless epoch — set "
                f"epoch_num = 1 (got {self.epoch_num})"
            )
        if self.dedup_gather_rows < 0:
            raise ValueError(
                f"dedup_gather_rows must be >= 0 (0 = off), got {self.dedup_gather_rows}"
            )
        if self.dedup_gather_rows > 0 and self.table_layout != "rows":
            # The dedup body gathers from the plain [V, D] table.
            raise ValueError("dedup_gather_rows > 0 requires table_layout = rows")
        if self.dedup_gather_rows > 0 and self.device_cache:
            raise ValueError(
                "dedup_gather_rows applies to the STREAMED path; "
                "device_cache slices resident batches (drop one)"
            )
        if self.dedup_gather_rows > 0 and self.paramstore:
            raise ValueError(
                "dedup_gather_rows is redundant under [ParamStore] "
                "(tiered resolution already dedups before the gather) "
                "— drop one"
            )
        if self.dedup_gather_rows > 0 and self.online_follow:
            # The follow stream runs no per-batch cap check.
            raise ValueError(
                "dedup_gather_rows with [Online] follow is not "
                "supported: the tail-following stream has no "
                "per-batch cap verification yet"
            )
        if self.paramstore:
            self._validate_paramstore()
        if self.delta_every_steps < 0:
            raise ValueError(
                f"delta_every_steps must be >= 0 (0 = off), got {self.delta_every_steps}"
            )
        if self.delta_every_steps > 0 and self.checkpoint_format == "orbax":
            raise ValueError(
                "delta_every_steps > 0 requires checkpoint_format = npz "
                "(the delta chain is an npz sidecar format)"
            )
        if self.delta_chain_max < 1:
            raise ValueError(
                f"delta_chain_max must be >= 1, got {self.delta_chain_max}"
            )
        if self.checkpoint_chunk_mb < 1:
            raise ValueError(
                f"checkpoint_chunk_mb must be >= 1, got {self.checkpoint_chunk_mb}"
            )
        if self.online_accum_restart_steps > 0 and self.delta_every_steps > 0:
            raise ValueError(
                "[Online] accum_restart_steps cannot combine with "
                "delta_every_steps: a global accumulator reset is not "
                "representable in a touched-row delta (resume would "
                "restore stale accumulators) — use full saves, or "
                "adagrad_decay"
            )
        if self.delta_full_every_s < 0 or self.delta_chain_max_bytes < 0:
            raise ValueError(
                "[Checkpoint] full_every_s and chain_max_bytes must be >= 0 "
                "(0 = off)"
            )
        if self.telemetry_mem_every_s < 0 or self.telemetry_stall_timeout_s < 0:
            raise ValueError(
                "telemetry_mem_every_s and telemetry_stall_timeout_s must be "
                ">= 0 (0 disables)"
            )
        if self.telemetry_profile_steps:
            # Parse-validate at config time, not at step N of a long run.
            from fast_tffm_tpu_torch.profiling import parse_profile_steps

            parse_profile_steps(self.telemetry_profile_steps)
        if self.telemetry_datastats_every_steps < 0:
            raise ValueError(
                "telemetry_datastats_every_steps must be >= 0 (0 = off), got "
                f"{self.telemetry_datastats_every_steps}"
            )
        if self.telemetry_heavy_hitter_k < 1:
            raise ValueError(
                f"telemetry_heavy_hitter_k must be >= 1, got "
                f"{self.telemetry_heavy_hitter_k}"
            )
        if self.on_nan not in ("abort", "rollback"):
            raise ValueError(f"unknown on_nan {self.on_nan!r} (abort | rollback)")
        if self.max_rollbacks < 0:
            raise ValueError(f"max_rollbacks must be >= 0, got {self.max_rollbacks}")
        if self.io_retries < 0:
            raise ValueError(f"io_retries must be >= 0, got {self.io_retries}")
        if self.io_retry_backoff_s < 0:
            raise ValueError(f"io_retry_backoff_s must be >= 0, got {self.io_retry_backoff_s}")
        if self.restart_max < 0:
            raise ValueError(f"restart_max must be >= 0, got {self.restart_max}")
        if self.restart_backoff_s < 0 or self.restart_backoff_max_s < 0:
            raise ValueError("restart_backoff_s and restart_backoff_max_s must be >= 0")
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
        if self.tail == "pallas" and self.dedup_gather_rows > 0:
            raise ValueError(
                "tail = pallas is incompatible with dedup_gather_rows > 0 "
                "(the kernel dedups internally — pick one)"
            )


def jax_fields(cfg) -> dict:
    """The fields of ``cfg`` (the port's Config or the JAX package's) as a
    dict without ``PORT_ONLY_KEYS``: what the JAX package's Config takes.
    A port-only key off its default has no JAX counterpart and raises."""
    fields = dataclasses.asdict(cfg)
    for key in PORT_ONLY_KEYS:
        default = Config.__dataclass_fields__[key].default
        if fields.pop(key, default) != default:
            raise ValueError(f"{key} = {getattr(cfg, key)!r} has no JAX counterpart")
    return fields


def check_deepfm_width(num_fields: int, max_nnz: int, model: str = "deepfm") -> None:
    """DeepFM (and DCN-V2) reshapes its [B, N, k] embeddings to [B, N·k]
    for a dense network whose input is num_fields·k wide, so N must be
    num_fields.  ``max_nnz`` 0 (inferred from the data) is checked once the
    entry point knows it (``Config.check_width``)."""
    if max_nnz and max_nnz != num_fields:
        raise ValueError(
            f"{model} needs max_nnz = num_fields (one slot per field, the MLP "
            f"input is num_fields·factor_num wide); got max_nnz {max_nnz} and "
            f"num_fields {num_fields}"
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
    cfg.num_fields = get(g, "num_fields", int, cfg.num_fields)
    cfg.hidden_dims = get(
        g, "hidden_dims", lambda s: tuple(int(x) for x in _split(s)), cfg.hidden_dims
    )
    cfg.compute_dtype = get(g, "compute_dtype", str, cfg.compute_dtype).lower()
    cfg.cross_layers = get(g, "cross_layers", int, cfg.cross_layers)
    cfg.cross_rank = get(g, "cross_rank", int, cfg.cross_rank)
    cfg.vocabulary_size = get(g, "vocabulary_size", int, cfg.vocabulary_size)
    cfg.vocabulary_block_num = get(g, "vocabulary_block_num", int, cfg.vocabulary_block_num)
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
    cfg.binary_cache_wait = get(t, "binary_cache_wait", float, cfg.binary_cache_wait)
    cfg.shuffle = get(t, "shuffle", boolean, cfg.shuffle)
    cfg.shuffle_seed = get(t, "shuffle_seed", int, cfg.shuffle_seed)
    cfg.device_cache = get(t, "device_cache", boolean, cfg.device_cache)
    cfg.dedup_gather_rows = get(t, "dedup_gather_rows", int, cfg.dedup_gather_rows)
    cfg.steps_per_call = get(t, "steps_per_call", int, cfg.steps_per_call)
    cfg.wire_format = get(t, "wire_format", str, cfg.wire_format).lower()
    cfg.queue_size = get(t, "queue_size", int, cfg.queue_size)
    cfg.log_every = get(t, "log_every", int, cfg.log_every)
    cfg.save_every_epochs = get(t, "save_every_epochs", int, cfg.save_every_epochs)
    cfg.trace_dir = get(t, "trace_dir", str, cfg.trace_dir)
    cfg.trace_steps = get(t, "trace_steps", int, cfg.trace_steps)
    cfg.metrics_path = get(t, "metrics_path", str, cfg.metrics_path)

    te = "Telemetry"
    cfg.telemetry_run_id = get(te, "run_id", str, cfg.telemetry_run_id)
    cfg.telemetry_mem_every_s = get(te, "mem_every_s", float, cfg.telemetry_mem_every_s)
    cfg.telemetry_stall_timeout_s = get(
        te, "stall_timeout_s", float, cfg.telemetry_stall_timeout_s
    )
    cfg.telemetry_compilation_cache_dir = get(
        te, "compilation_cache_dir", str, cfg.telemetry_compilation_cache_dir
    )
    cfg.telemetry_profile_steps = get(te, "profile_steps", str, cfg.telemetry_profile_steps)
    cfg.telemetry_profile_costs = get(te, "profile_costs", boolean, cfg.telemetry_profile_costs)
    cfg.telemetry_datastats_every_steps = get(
        te, "datastats_every_steps", int, cfg.telemetry_datastats_every_steps
    )
    cfg.telemetry_heavy_hitter_k = get(te, "heavy_hitter_k", int, cfg.telemetry_heavy_hitter_k)
    c = "Checkpoint"
    cfg.async_save = get(c, "async_save", boolean, cfg.async_save)
    cfg.delta_every_steps = get(c, "delta_every_steps", int, cfg.delta_every_steps)
    cfg.delta_chain_max = get(c, "delta_chain_max", int, cfg.delta_chain_max)
    cfg.delta_full_every_s = get(c, "full_every_s", float, cfg.delta_full_every_s)
    cfg.delta_chain_max_bytes = get(c, "chain_max_bytes", int, cfg.delta_chain_max_bytes)
    cfg.checkpoint_chunk_mb = get(c, "chunk_mb", int, cfg.checkpoint_chunk_mb)

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
    cfg.serve_reload_max_retries = get(
        s, "reload_max_retries", int, cfg.serve_reload_max_retries
    )
    cfg.serve_port = get(s, "port", int, cfg.serve_port)
    cfg.serve_replicas = get(s, "replicas", int, cfg.serve_replicas)
    cfg.serve_deadline_ms = get(s, "deadline_ms", float, cfg.serve_deadline_ms)
    cfg.serve_metrics_every_s = get(s, "metrics_every_s", float, cfg.serve_metrics_every_s)
    cfg.serve_classes = get(s, "classes", str, cfg.serve_classes)
    cfg.serve_wire = get(s, "wire", str, cfg.serve_wire).lower()
    cfg.serve_affinity = get(s, "affinity", boolean, cfg.serve_affinity)

    o = "Online"
    cfg.online_follow = get(o, "follow", boolean, cfg.online_follow)
    cfg.online_poll_s = get(o, "poll_s", float, cfg.online_poll_s)
    cfg.online_idle_timeout_s = get(o, "idle_timeout_s", float, cfg.online_idle_timeout_s)
    cfg.online_max_batches = get(o, "max_batches", int, cfg.online_max_batches)
    cfg.online_adagrad_decay = get(o, "adagrad_decay", float, cfg.online_adagrad_decay)
    cfg.online_accum_restart_steps = get(
        o, "accum_restart_steps", int, cfg.online_accum_restart_steps
    )
    ps = "ParamStore"
    cfg.paramstore = get(ps, "enabled", boolean, cfg.paramstore)
    cfg.paramstore_hot_rows = get(ps, "hot_rows", int, cfg.paramstore_hot_rows)
    cfg.paramstore_miss_rows = get(ps, "miss_rows", int, cfg.paramstore_miss_rows)
    cfg.paramstore_dir = get(ps, "store_dir", str, cfg.paramstore_dir)
    cfg.paramstore_residency = get(ps, "residency", str, cfg.paramstore_residency)
    cfg.paramstore_sample_batches = get(
        ps, "sample_batches", int, cfg.paramstore_sample_batches
    )
    cfg.paramstore_materialize = get(ps, "materialize", str, cfg.paramstore_materialize).lower()
    r = "Resilience"
    cfg.on_nan = get(r, "on_nan", str, cfg.on_nan).lower()
    cfg.max_rollbacks = get(r, "max_rollbacks", int, cfg.max_rollbacks)
    cfg.io_retries = get(r, "io_retries", int, cfg.io_retries)
    cfg.io_retry_backoff_s = get(r, "io_retry_backoff_s", float, cfg.io_retry_backoff_s)
    cfg.restart_max = get(r, "restart_max", int, cfg.restart_max)
    cfg.restart_backoff_s = get(r, "restart_backoff_s", float, cfg.restart_backoff_s)
    cfg.restart_backoff_max_s = get(
        r, "restart_backoff_max_s", float, cfg.restart_backoff_max_s
    )
    d = "Distributed"
    cfg.data_parallel = get(d, "data_parallel", int, cfg.data_parallel)
    cfg.row_parallel = get(d, "row_parallel", int, cfg.row_parallel)
    cfg.lookup = get(d, "lookup", str, cfg.lookup).lower()
    cfg.lookup_overflow = get(d, "lookup_overflow", str, cfg.lookup_overflow).lower()
    cfg.lookup_capacity_factor = get(
        d, "lookup_capacity_factor", float, cfg.lookup_capacity_factor
    )
    cfg.coordinator_address = get(d, "coordinator_address", str, cfg.coordinator_address)
    cfg.num_processes = get(d, "num_processes", int, cfg.num_processes)
    cfg.process_id = get(d, "process_id", int, cfg.process_id)
    cfg.input_assignment = get(d, "input_assignment", str, cfg.input_assignment).lower()
    cfg.runtime_dir = get(d, "runtime_dir", str, cfg.runtime_dir)
    cfg.heartbeat_s = get(d, "heartbeat_s", float, cfg.heartbeat_s)
    cfg.host_stall_timeout_s = get(
        d, "host_stall_timeout_s", float, cfg.host_stall_timeout_s
    )
    cfg.barrier_timeout_s = get(d, "barrier_timeout_s", float, cfg.barrier_timeout_s)
    return cfg.validate()


def build_model(cfg: Config):
    """Instantiate the configured model (the JAX ``build_model``, and the
    port's own DCN-V2); an unknown name raises, validated or not."""
    from fast_tffm_tpu_torch.models import DCNv2Model, DeepFMModel, FFMModel, FMModel

    if cfg.model == "fm":
        return FMModel(
            vocabulary_size=cfg.vocabulary_size,
            factor_num=cfg.factor_num,
            order=cfg.order,
            init_value_range=cfg.init_value_range,
            factor_lambda=cfg.factor_lambda,
            bias_lambda=cfg.bias_lambda,
        )
    if cfg.model == "ffm":
        return FFMModel(
            vocabulary_size=cfg.vocabulary_size,
            num_fields=cfg.num_fields,
            factor_num=cfg.factor_num,
            init_value_range=cfg.init_value_range,
            factor_lambda=cfg.factor_lambda,
            bias_lambda=cfg.bias_lambda,
            compute_dtype=cfg.compute_dtype,
        )
    if cfg.model == "dcnv2":
        return DCNv2Model(
            vocabulary_size=cfg.vocabulary_size,
            num_fields=cfg.num_fields,
            factor_num=cfg.factor_num,
            cross_layers=cfg.cross_layers,
            cross_rank=cfg.cross_rank,
            hidden_dims=cfg.hidden_dims,
            init_value_range=cfg.init_value_range,
            factor_lambda=cfg.factor_lambda,
            bias_lambda=cfg.bias_lambda,
            compute_dtype=cfg.compute_dtype,
        )
    if cfg.model != "deepfm":  # an unvalidated Config must not train another model
        raise ValueError(f"unknown model {cfg.model!r}")
    return DeepFMModel(
        vocabulary_size=cfg.vocabulary_size,
        num_fields=cfg.num_fields,
        factor_num=cfg.factor_num,
        hidden_dims=cfg.hidden_dims,
        init_value_range=cfg.init_value_range,
        factor_lambda=cfg.factor_lambda,
        bias_lambda=cfg.bias_lambda,
        compute_dtype=cfg.compute_dtype,
    )
