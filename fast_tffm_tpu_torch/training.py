"""The local training driver — the counterpart of ``fast_tffm_tpu/training.py``
``train`` + ``_run_training`` (single device).

  train(cfg, resume=False, log=print, device=None, step_hook=None) -> TrainState

Input, as in the JAX package:

* streamed (the default): one prefetched stream per epoch
  (``data/pipeline.batch_stream``): text parsed by the native C++ parser
  with ``thread_num`` threads, or FMB files by memmap; ``binary_cache``
  converts text to ``<file>.fmb`` once and streams that; ``shuffle``
  draws a fresh permutation of the rows per epoch (FMB input).
* ``device_cache``: the FMB-backed train set is resident on the device
  and every step gathers its batch there (``data/device_cache.py``).

``steps_per_call`` K > 1 runs K steps per call (``trainer.
make_scanned_train_step``; cached: ``make_cached_scan_train_step``): on
the card one replay of a CUDA graph of the K steps, on the CPU a loop,
bitwise K single steps either way; the epoch's last group is shorter.
K = 1 is the eager step.

A log line every ``log_every`` steps (mean loss, examples/sec, in the JAX
package's wording; K-step aligned), a non-finite loss check on every
K-step group (one group late, so the host does not wait on the group it
just launched) and at every log point before any save, the validation AUC
over ``validation_files`` and a save every ``save_every_epochs`` epochs;
the final state is saved and returned.  ``device`` None means the card.

Exact-position resume: the loop tracks the input cursor (epoch, batch in
the epoch, and the input's identity: batch size, shuffle and seed, the
train files' fingerprint), K batches a K-step call, and every save embeds
it (``input_cursor``, the JAX package's member and JSON): an epoch-end
save names the next epoch's start.  ``resume`` restores ``model_file`` and
reopens the input at its cursor's batch on every input path (the seek of
``batch_stream(skip_rows=)``, the device cache's clipped index chunks),
so the resumed run is bitwise the run that was never stopped.  A cursor
that does not match this config, or a checkpoint without one, starts at
the first file with a warning or a note, as in the JAX package.  The
first SIGTERM or SIGINT (or one raised by ``step_hook(step)``, called
after every call) finishes the current call, drains the finite check,
saves with the cursor and returns; a second one takes the default
handler.  The handlers are installed on the main thread only, and
restored on the way out.

The table layouts.  ``rows``: the sparse tail is the rows Adagrad
kernel's wrapper (``trainer.train_step_body``).  ``dedup_gather_rows`` > 0
names the JAX package's dedup before the forward gather, which cuts the
TPU's gather bytes and gives the direct gather's values: the port logs a
note and gathers directly, and each streamed batch's unique ids are still
checked against the cap before it ships, so a config fails here where it
fails in the JAX package.  ``packed``: the state is lane-packed (``trainer.
pack_state``) after the logical restore or init; with ``adagrad_accumulator
= fused`` steps gather through ``fused_gather`` and end in the fused
Adagrad kernel, with ``element`` or ``row`` through ``packed_gather`` and
the rows kernel at the packed address (``trainer.packed_train_step_body``);
validation scores through the packed gathers, and every save writes the
logical arrays (``trainer.unpack_state``).  Each tail is its kernel on the
card, whatever ``[Train] tail`` and ``packed_update`` say, and its plain
twin on the CPU; a setting that names a JAX compiler path the port has no
counterpart of says so in the log on the card.

Telemetry, as in the JAX package: a ``telemetry.RunMonitor`` writes the
enveloped records to ``metrics_path`` — kind=train at every log point,
kind=input (streamed input), kind=validation, kind=compile (kernel builds
and graph captures: warm-up in the first epoch this process runs, where the
first call also runs inside ``warmup_window``; steady-state after),
kind=mem (sampled by the monitor's own thread), kind=stall (the watchdog:
no call completed for ``stall_timeout_s``; ``step_hook`` runs after the
call's heartbeat, so a frozen hook fires it), kind=anomaly before a
non-finite abort, kind=profile (``profiling.CostLedger``: one record per
step program; ``StepProfiler``'s trace start and stop), kind=datastats,
kind=ckpt and the closing kind=summary.  ``trace_dir`` adds a
``torch.profiler`` window of ``trace_steps`` calls.  The per-call work is
host-only: no device sync is added.  Every save goes through
``checkpoint_async.AsyncCheckpointer``: ``async_save`` takes the epoch
saves off the loop, ``delta_every_steps`` writes delta files of the touched
rows between them; the stop and final saves stay synchronous.  Rollback,
the tiered store, online learning and the supervisor are later slices;
``train`` refuses their config keys before it touches a device.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal
import threading

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import read_input_cursor, restore_checkpoint
from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer
from fast_tffm_tpu_torch.config import Config, build_model, refuse_later_slices
from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache, fold_epoch_seed, is_fmb
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.data.native import best_parser
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.metrics import StreamingAUC, Throughput
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.profiling import (
    CostLedger,
    DataStatsCollector,
    StepProfiler,
    modeled_step_bytes,
)
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.trainer import (
    init_packed_state,
    init_state,
    make_decayed_body,
    make_packed_predict_step,
    make_predict_step,
    make_scanned_train_step,
    make_train_step,
    pack_state,
    packed_train_step_body,
    unpack_state,
)
from fast_tffm_tpu_torch.utils.prefetch import InputStats, InputStream, grouped_pairs, prefetch
from fast_tffm_tpu_torch.utils.step_graph import StepGraphs
from fast_tffm_tpu_torch.utils.tracing import WindowTracer, step_trace

__all__ = ["train", "binary_input", "NonFiniteLossError"]


class NonFiniteLossError(RuntimeError):
    """The training loss went non-finite; raised before any save."""

    def __init__(self, msg: str, *, step: int, loss: float):
        super().__init__(msg)
        self.step = step
        self.loss = loss


def _check_finite(loss: float, step: int, anomaly=None) -> None:
    """Abort on a non-finite loss instead of training on (and eventually
    checkpointing) poisoned state (``on_nan = abort``).  ``anomaly(step,
    loss)`` records the divergence (a kind=anomaly record) before the raise."""
    if not np.isfinite(loss):
        if anomaly is not None:
            anomaly(step, loss)
        raise NonFiniteLossError(
            f"training loss is {loss}; likely a diverged model — lower "
            "learning_rate.  Aborting before the next checkpoint overwrites "
            "the last good state.",
            step=int(step),
            loss=float(loss),
        )


class _GroupCheck:
    """The finite check on each K-step group's losses, one group late.
    ``push`` starts copying a group's [K] losses to the host behind it on
    the card's stream and then checks the group before it, whose copy the
    card has finished or is about to: the host never waits on the group
    it just launched, so it builds the next while the card runs.  The
    check is never inside a captured graph.  ``drain`` checks the last
    group (at log points and before a save).  A K = 1 step's 0-d loss is
    left to the log-point check, as in the JAX package."""

    def __init__(self, device, anomaly=None):
        self._cuda = device.type == "cuda"
        self._anomaly = anomaly
        self._last = None  # (host losses, copy event or None, step after the group)

    def push(self, loss: torch.Tensor, step: int) -> None:
        last, self._last = self._last, None
        if loss.dim():
            if self._cuda:
                host = torch.empty(loss.shape, dtype=loss.dtype, pin_memory=True)
                host.copy_(loss, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                self._last = (host, done, step)
            else:
                self._last = (loss, None, step)
        if last is not None:
            self._check(*last)

    def drain(self) -> None:
        if self._last is not None:
            self._check(*self._last)
            self._last = None

    def _check(self, host: torch.Tensor, done, step: int) -> None:
        if done is not None:
            done.synchronize()
        _check_finite(float(host.mean()), step, self._anomaly)


def binary_input(files) -> bool:
    """True when every file of the (cache-resolved) list is FMB: the stream
    is memmap-backed, not parsed."""
    return bool(files) and all(is_fmb(f) for f in files)


def _files_fingerprint(files) -> str:
    """The train input's identity in the resume cursor: the file list and
    each file's size (the JAX package's function: a cursor's batch offset
    means nothing against files that grew, shrank or were replaced)."""
    h = hashlib.md5()
    for p in files:
        try:
            size = os.path.getsize(p)
        except OSError:
            size = -1
        h.update(f"{p}:{size}\n".encode())
    return h.hexdigest()[:16]


def _resolve_cursor(cfg: Config, cursor, log) -> tuple[int, int]:
    """(start_epoch, start_batch) from a restored input cursor — the JAX
    ``_resolve_cursor`` for one process.

    A cursor that does not describe this run's input (batch size, shuffle
    and its seed, a follow cursor, the train files' fingerprint), or one of
    a newer version, starts at (0, 0) with a warning.  A cursor at or past
    ``epoch_num`` is a completed run: resume then trains ``epoch_num``
    more epochs from (0, 0), unless it is ``_exact`` (a literal position:
    ``(epoch_num, 0)``, no input left).  A ``hosts`` vector of one entry
    resolves to that entry; any other vector was saved by another number
    of processes and takes the warned start, as a topology change does in
    the JAX package."""
    if not cursor:
        return 0, 0
    exact = bool(cursor.pop("_exact", False))
    if int(cursor.get("version", 0)) > 1:
        log(
            "warning: checkpoint input cursor has a newer version "
            f"({cursor.get('version')}) than this build understands — "
            "resuming at the start of the data (legacy behavior)"
        )
        return 0, 0
    hosts = cursor.pop("hosts", None)
    saved_pcount = cursor.pop("process_count", None)
    if hosts is not None:
        if (saved_pcount or len(hosts)) != 1 or not hosts:
            log(
                "warning: checkpoint cursor vector was saved by "
                f"{saved_pcount or len(hosts)} host(s), this run has "
                "1 — resuming at the start of the data (legacy "
                "behavior)"
            )
            return 0, 0
        mine = hosts[0] or {}
        if mine.get("epoch") is not None:
            cursor["epoch"] = int(mine["epoch"])
            cursor["batch_in_epoch"] = int(mine.get("batch_in_epoch") or 0)
    mismatched = [
        f"{key} {cursor.get(key)!r} != {want!r}"
        for key, want in (
            ("batch_size", int(cfg.batch_size)),
            ("shuffle", bool(cfg.shuffle)),
            ("shuffle_seed", int(cfg.shuffle_seed) if cfg.shuffle else cursor.get("shuffle_seed")),
            # This run does not follow a stream (online learning is a later
            # slice), so a follow cursor never matches.
            ("follow", False if "follow" in cursor else None),
            ("files", _files_fingerprint(cfg.train_files)),
        )
        if cursor.get(key) != want
    ]
    if mismatched:
        log(
            "warning: checkpoint input cursor does not match this config "
            f"({'; '.join(mismatched)}) — resuming at the start of the "
            "data (legacy behavior)"
        )
        return 0, 0
    e = max(0, int(cursor.get("epoch", 0)))
    b = max(0, int(cursor.get("batch_in_epoch", 0)))
    if e >= cfg.epoch_num:
        return (cfg.epoch_num, 0) if exact else (0, 0)
    log(f"resuming input at epoch {e}, batch {b} (exact-position cursor)")
    return e, b


def _dedup_cap_guard(raw, cap: int):
    """Each batch's unique-id count checked against ``dedup_gather_rows``
    before it ships (in the prefetch thread), with the JAX package's
    error: its dedup gather keeps at most ``cap`` unique rows, so a larger
    batch is a loud error naming the knob there, and here too."""
    for p, w in raw:
        u = int(np.unique(p.ids).size)
        if u > cap:
            raise ValueError(
                f"dedup_gather_rows = {cap} but a batch carries {u} unique "
                "ids — the jitted dedup gather would silently drop rows.  "
                "Raise dedup_gather_rows (or set 0 to disable)."
            )
        yield p, w


def _stream(cfg: Config, files, max_nnz: int, weights=None, shuffle_epoch=None,
            steps_per_call: int = 1, log=print, skip_batches: int = 0, dedup_cap: int = 0):
    """One prefetched pass over ``files`` (an ``InputStream``: its stats feed
    kind=input records): (ParsedBatch, weights) pairs, or K-long lists of
    them when ``steps_per_call`` > 1.  Text parses through
    the native parser; ``binary_cache`` resolves the FMB caches first (an
    unwritable location falls back to the text, and a shuffle on that
    fallback is dropped with a log line); ``shuffle_epoch`` (train streams)
    folds the epoch into ``shuffle_seed``.  ``skip_batches`` opens the
    pass at that batch (the resume seek); ``dedup_cap`` > 0 checks each
    batch's unique ids against it before the batch ships."""
    files = tuple(files)
    parser = best_parser(cfg.thread_num)
    if cfg.binary_cache:
        files = ensure_fmb_cache(
            files, vocabulary_size=cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
            max_nnz=max_nnz, parser=parser, log=log,
        )
    shuffle_seed = (
        fold_epoch_seed(cfg.shuffle_seed, shuffle_epoch)
        if cfg.shuffle and shuffle_epoch is not None
        else None
    )
    if shuffle_seed is not None and cfg.binary_cache and not binary_input(files):
        log("shuffle disabled: the binary cache is unavailable (text fallback) and "
            "text streaming cannot reorder rows")
        shuffle_seed = None
    raw = batch_stream(
        files,
        batch_size=cfg.batch_size,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        max_nnz=max_nnz,
        weights=weights,
        parser=parser,
        shuffle_seed=shuffle_seed,
        skip_rows=skip_batches * cfg.batch_size,
        io_retries=cfg.io_retries,
        io_retry_backoff_s=cfg.io_retry_backoff_s,
        log=log,
    )
    if dedup_cap > 0:
        raw = _dedup_cap_guard(raw, dedup_cap)
    if steps_per_call > 1:
        raw = grouped_pairs(raw, steps_per_call)
    # An item holds K batches: scale the depth down to keep the host memory
    # in flight at the K = 1 level.
    stats = InputStats()
    depth = max(1, cfg.queue_size // max(1, steps_per_call))
    return InputStream(prefetch(stats.timed(raw), depth=depth, stats=stats), stats)


def _evaluate(cfg: Config, model, predict_step, state, files, max_nnz: int, device, log) -> float:
    """AUC over ``files`` through the predict step, folded into a bounded
    streaming AUC (validation examples weigh 1.0; batch padding 0)."""
    meter = StreamingAUC()
    for parsed, w in _stream(cfg, files, max_nnz, log=log):
        scores = predict_step(
            state, Batch.from_parsed(parsed, w, device, with_fields=model.uses_fields))
        meter.add(parsed.labels, scores.cpu().numpy(), w)
    return meter.value()


def _mean(losses) -> float:
    return float(torch.cat([l.reshape(-1) for l in losses]).mean())


def _refuse_later_slices(cfg: Config) -> None:
    """The training settings whose paths are later slices of the port."""
    refuse_later_slices("train", [
        (cfg.paramstore, "[ParamStore] (the tiered parameter store)"),
        (cfg.online_follow, "[Online] follow (online learning)"),
        (cfg.online_accum_restart_steps > 0, "[Online] accum_restart_steps"),
        (cfg.on_nan == "rollback", "on_nan = rollback (resilience)"),
    ])


def _device_cached_input(cfg: Config, model, max_nnz: int, log, body, device):
    """``device_cache = true``: the train set as resident device arrays.
    Input must be FMB-backed (.fmb train_files, or ``binary_cache`` to
    convert text once).  Returns ``(step_fn, train_stream, ids_of)``: the
    stream yields (batch index or [K] index chunk, examples) and the step
    gathers the batch on the device, through the epoch's permutation when
    shuffling; ``ids_of(item)`` gives that call's ids from the resident
    arrays.  ``train_stream(epoch, skip_batches)`` opens the epoch at that
    batch: K = 1 skips the first indices, K > 1 clips the epoch's K-grid of
    chunks (``epoch_index_chunks(start=)``)."""
    from fast_tffm_tpu_torch.data.device_cache import (
        call_ids,
        epoch_index_chunks,
        full_epoch_perm,
        load_device_dataset,
        make_cached_scan_train_step,
        make_cached_train_step,
        set_permutation,
    )

    files = tuple(cfg.train_files)
    if cfg.binary_cache:
        files = ensure_fmb_cache(
            files, vocabulary_size=cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
            max_nnz=max_nnz, parser=best_parser(cfg.thread_num), log=log,
        )
    if not binary_input(files):
        raise ValueError(
            "device_cache = true needs FMB-backed input: list .fmb files in "
            "train_files, or set binary_cache = true to convert text once"
        )
    data = load_device_dataset(
        files, batch_size=cfg.batch_size, vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id, max_nnz=max_nnz,
        weights=cfg.weight_files or None, with_fields=model.uses_fields, device=device,
    )
    log(
        f"device cache: {data.n_rows} rows resident "
        f"({data.nbytes / 2**20:.1f} MiB, {data.batches} batches/epoch)"
    )
    k = cfg.steps_per_call
    if k > 1:
        step, step_shuffled = make_cached_scan_train_step(model, cfg.learning_rate, data, body)
        items = epoch_index_chunks(data.batches, k, device)
    else:
        step, step_shuffled = make_cached_train_step(model, cfg.learning_rate, data, body)
        items = [torch.tensor(i, dtype=torch.int64, device=device) for i in range(data.batches)]

    def train_stream(epoch, skip_batches=0):
        if cfg.shuffle:
            set_permutation(data, full_epoch_perm(data, cfg.shuffle_seed, epoch))
        use = items
        if skip_batches:
            use = (epoch_index_chunks(data.batches, k, device, start=skip_batches) if k > 1
                   else items[skip_batches:])
        return ((i, cfg.batch_size * i.numel()) for i in use)

    def ids_of(i):
        return call_ids(data, i, cfg.shuffle)

    return (step_shuffled if cfg.shuffle else step), train_stream, ids_of


def _signal_stop(log):
    """(stop event, restore) for the first-signal stop: SIGTERM and SIGINT
    set the event and put back their previous handler, so a second signal
    takes it.  Installed on the main thread only (``signal.signal`` works
    nowhere else); ``restore()`` reinstates the previous handlers."""
    stop = threading.Event()
    previous = {}

    def on_signal(signum, frame):
        log(f"received signal {signum}: checkpointing after current step")
        stop.set()
        signal.signal(signum, previous[signum])

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, on_signal)

    def restore():
        for sig, handler in previous.items():
            signal.signal(sig, handler)

    return stop, restore


def _graphs_of(step_fn) -> StepGraphs | None:
    """The CUDA-graph wrapper behind a K-step ``step_fn``, if any."""
    if isinstance(step_fn, StepGraphs):
        return step_fn
    return getattr(step_fn, "graphs", None)


def _modeled_bytes(ids: torch.Tensor, row_dim: int, accum_cols: int) -> int:
    """``modeled_step_bytes`` of one call's ids, summed per batch when they
    carry the K-step dim ([K, B, N]), as the JAX package sums its K-list."""
    host = ids.cpu().numpy()
    parts = host if host.ndim == 3 else [host]
    return sum(modeled_step_bytes(p, row_dim, accum_cols)[0] for p in parts)


def train(cfg: Config, *, resume: bool = False, log=print, device=None, step_hook=None):
    """Local (single-device) training — the reference's ``train`` mode.

    ``resume`` restores ``cfg.model_file`` (table, accumulators, step; the
    delta chain replayed) and reopens the input at its cursor; otherwise
    the state is a fresh init from a seeded generator.  ``step_hook(step)``
    runs after every call, before the stop check (a test raises SIGTERM
    from it at an exact step).  Returns the final state in the layout it
    trained in (a packed or fused state for ``table_layout = packed``); its
    logical arrays are saved to ``cfg.model_file`` with the cursor."""
    _refuse_later_slices(cfg)
    if not cfg.train_files:
        raise ValueError("no train_files configured")
    if cfg.weight_files and len(cfg.weight_files) != len(cfg.train_files):
        raise ValueError(
            f"weight_files has {len(cfg.weight_files)} entries for "
            f"{len(cfg.train_files)} train_files (they align per-file)"
        )
    device = resolve_device(device)
    model = build_model(cfg)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    packed = cfg.table_layout == "packed"
    fused = packed and cfg.adagrad_accumulator == "fused"
    start_cursor = None
    if resume:
        # The logical arrays first, packed after (never a fresh packed state
        # beside them).
        accum_width = model.row_dim if cfg.adagrad_accumulator == "element" else 1
        state = restore_checkpoint(cfg.model_file, device, n_dense=len(model.dense_names),
                                   accum_width=accum_width)
        if state.table.shape != (model.vocabulary_size, model.row_dim):
            raise ValueError(
                f"checkpoint {cfg.model_file!r} holds a {tuple(state.table.shape)} table; "
                f"this config trains [{model.vocabulary_size}, {model.row_dim}]"
            )
        if packed:
            state = pack_state(state, cfg.init_accumulator_value, fused=fused)
        log(f"resumed from {cfg.model_file} at step {state.step}" + (" (packed)" if packed else ""))
        start_cursor = read_input_cursor(cfg.model_file)
        if start_cursor is None:
            log(
                "note: checkpoint carries no input cursor (pre-resilience "
                "format) — input restarts at the first file (legacy resume)"
            )
    else:
        generator = torch.Generator(device=device).manual_seed(0)
        if packed:
            state = init_packed_state(model, generator, cfg.init_accumulator_value,
                                      cfg.adagrad_accumulator)
        else:
            state = init_state(
                model, generator, cfg.init_accumulator_value, cfg.adagrad_accumulator
            )
    kernel = "fused Adagrad kernel" if fused else "rows Adagrad kernel"
    if device.type == "cuda" and (cfg.tail == "xla" or cfg.packed_update != "auto"):
        log(
            f"note: tail = {cfg.tail}, packed_update = {cfg.packed_update} name JAX "
            "compiler paths for the same update, which the port does not have; "
            f"running the {kernel}"
        )
    if packed:
        if fused:
            log("sparse tail: fused_tail_adagrad (fused one-pass gather→Adagrad→scatter)")
        else:
            log(f"sparse tail: rows_tail_adagrad at the packed address "
                f"({cfg.adagrad_accumulator} accumulator)")
        body = lambda mdl, lr, st, b: packed_train_step_body(  # noqa: E731
            mdl, lr, st, b, cfg.packed_compact_cap
        )
        predict_step = make_packed_predict_step(model, fused=fused)
    else:
        if cfg.dedup_gather_rows > 0:
            log(f"note: dedup_gather_rows = {cfg.dedup_gather_rows} names the JAX package's "
                "dedup before the gather (the same values, fewer TPU gather bytes); the port "
                "gathers directly and checks each batch's unique ids against the cap")
        body = make_decayed_body(cfg.online_adagrad_decay)
        predict_step = make_predict_step(model)
    k = cfg.steps_per_call
    if cfg.device_cache:
        step_fn, train_stream, ids_of = _device_cached_input(cfg, model, max_nnz, log, body,
                                                             device)
    else:
        step_fn = (make_scanned_train_step if k > 1 else make_train_step)(
            model, cfg.learning_rate, body=body
        )
        weights = cfg.weight_files or None

        def train_stream(epoch, skip_batches=0):
            src = _stream(cfg, cfg.train_files, max_nnz, weights, shuffle_epoch=epoch,
                          steps_per_call=k, log=log, skip_batches=skip_batches,
                          dedup_cap=cfg.dedup_gather_rows)

            def batches():
                for parsed, w in src:
                    if isinstance(parsed, list):
                        yield (Batch.stack_parsed(parsed, w, with_fields=model.uses_fields),
                               sum(p.batch_size for p in parsed))
                    else:
                        yield (Batch.from_parsed(parsed, w, device,
                                                 with_fields=model.uses_fields),
                               parsed.batch_size)

            return InputStream(batches(), src.stats)

        def ids_of(batch):
            # A K-step call's superbatch is on the host; its graph's static
            # buffers hold the same ids on the card.
            return step_fn.last_batch().ids if k > 1 else batch.ids

    # The input cursor, tracked per call: every save embeds it.
    start_epoch, start_batch = _resolve_cursor(cfg, start_cursor, log)
    cur = {"epoch": start_epoch, "batch": start_batch}
    files_fp = _files_fingerprint(cfg.train_files)

    def input_cursor() -> dict:
        return {
            "version": 1,
            "epoch": cur["epoch"],
            "batch_in_epoch": cur["batch"],
            "batch_size": int(cfg.batch_size),
            "shuffle": bool(cfg.shuffle),
            "shuffle_seed": int(cfg.shuffle_seed),
            "steps_per_call": int(k),
            "files": files_fp,
        }

    cuda = device.type == "cuda"
    monitor = RunMonitor(
        cfg.metrics_path or None, run_id=cfg.telemetry_run_id, source="train",
        stall_timeout_s=cfg.telemetry_stall_timeout_s, mem_every_s=cfg.telemetry_mem_every_s,
        device=device, log=log,
    )
    tracer = WindowTracer(cfg.trace_dir, count=cfg.trace_steps, cuda=cuda)
    profiler = StepProfiler(cfg.telemetry_profile_steps,
                            cfg.trace_dir or (cfg.model_file + ".profile"),
                            monitor=monitor, log=log, cuda=cuda)
    ledger = CostLedger(monitor) if cfg.telemetry_profile_costs else None
    datastats = None
    if cfg.telemetry_datastats_every_steps > 0:
        datastats = DataStatsCollector(
            monitor, vocab=cfg.vocabulary_size, row_dim=model.row_dim,
            every_steps=cfg.telemetry_datastats_every_steps,
            heavy_hitter_k=cfg.telemetry_heavy_hitter_k, ids_fn=ids_of,
        )
    accum_cols = model.row_dim if cfg.adagrad_accumulator == "element" else 1
    graphs = _graphs_of(step_fn)
    captures = graphs.captures if graphs is not None else 0
    saveable = lambda st: unpack_state(st, model)  # noqa: E731
    ckpt = AsyncCheckpointer(
        cfg.model_file, device=device, monitor=monitor, log=log,
        chunk_bytes=cfg.checkpoint_chunk_mb << 20, async_save=cfg.async_save,
        delta_every_steps=cfg.delta_every_steps, delta_chain_max=cfg.delta_chain_max,
        full_every_s=cfg.delta_full_every_s, chain_max_bytes=cfg.delta_chain_max_bytes,
        vocab=cfg.vocabulary_size, row_dim=model.row_dim,
        start_step=state.step, cursor_fn=input_cursor,
    )

    def anomaly(step, loss):
        monitor.emit_anomaly(step, loss, state=state)

    meter = Throughput()
    losses: list[torch.Tensor] = []  # device values; synced at log points
    groups = _GroupCheck(device, anomaly)
    pending = 0  # steps since the last log point
    counted = 0  # examples the meter holds
    start_step = state.step
    stop, restore_handlers = _signal_stop(log)
    try:
        for epoch in range(start_epoch, cfg.epoch_num):
            if stop.is_set():
                break
            # A resumed first epoch reopens at the cursor's batch.
            epoch_stream = train_stream(epoch, cur["batch"] if epoch == start_epoch else 0)
            input_stats = getattr(epoch_stream, "stats", None)
            monitor.set_queue_depth_fn(getattr(epoch_stream, "queue_depth", None))
            monitor.set_producer_alive_fn(getattr(epoch_stream, "producer_alive", None))
            for batch, examples in epoch_stream:
                first_call = state.step == start_step
                tracer.on_step()
                # Call 1 pays the kernel builds and the graph capture.
                with monitor.warmup_window() if first_call else contextlib.nullcontext():
                    with step_trace("train", state.step, cuda):
                        state, loss = step_fn(state, batch)
                cur["batch"] += loss.numel()  # K batches consumed
                groups.push(loss, state.step)
                if first_call:
                    # The meter's window starts after call 1 and holds none
                    # of its examples (builds, capture, allocator warm-up).
                    if cuda:
                        torch.cuda.synchronize(device)
                    meter.reset()
                else:
                    meter.add(examples)
                    counted += examples
                # Heartbeat and compile drain: the first epoch this process
                # runs (a K-step run's short epoch tail captures there) is
                # warm-up, any build or capture later is steady-state.
                monitor.on_dispatch(state.step, warmup=(epoch == start_epoch))
                profiler.on_step(state.step)
                if ledger is not None:
                    now = graphs.captures if graphs is not None else 0
                    if ledger.want("train_step"):
                        ledger.stage("train_step", examples=examples,
                                     modeled_bytes=_modeled_bytes(ids_of(batch), model.row_dim,
                                                                  accum_cols))
                    if now > captures:
                        ledger.stage(f"train_graph_k{loss.numel()}", examples=examples,
                                     modeled_bytes=_modeled_bytes(ids_of(batch), model.row_dim,
                                                                  accum_cols))
                    captures = now
                    ledger.flush(state.step)
                if datastats is not None:
                    datastats.note(state.step, batch=batch)
                if ckpt.delta_enabled:
                    ckpt.note_batch(ids_of(batch))
                    if ckpt.delta_due(state.step) and not stop.is_set():
                        with monitor.suspended():
                            ckpt.delta_boundary(state, saveable, state.step)
                losses.append(loss)
                pending += loss.numel()
                if step_hook is not None:
                    step_hook(state.step)  # before the stop check: a raised signal stops here
                if stop.is_set():
                    break
                if pending >= cfg.log_every:
                    pending = 0
                    groups.drain()
                    mean_loss = _mean(losses)
                    # Read after the sync above, so the window's examples are
                    # trained, not only launched.
                    rate = meter.rate()
                    _check_finite(mean_loss, state.step, anomaly)
                    # A window that holds only the first call (K >= log_every)
                    # has no examples to rate: its line gives the loss alone.
                    log(
                        f"step {state.step} epoch {epoch} loss {mean_loss:.5f}"
                        + (f" examples/sec {rate:,.0f} (/chip {rate:,.0f})" if counted else "")
                    )
                    monitor.emit(
                        "train", step=state.step, epoch=epoch, loss=round(mean_loss, 6),
                        examples_per_sec=round(rate, 1) if counted else None,
                        examples_per_sec_per_chip=round(rate, 1) if counted else None,
                    )
                    if input_stats is not None and (rec := input_stats.drain()):
                        monitor.emit("input", step=state.step, epoch=epoch, **rec)
                    losses.clear()
                    meter.reset()
                    counted = 0
            if stop.is_set():
                break
            if input_stats is not None and (rec := input_stats.drain()):
                monitor.emit("input", step=state.step, epoch=epoch, **rec)
            # A poisoned state must abort BEFORE the cursor moves and the save
            # below replaces the last good checkpoint.
            groups.drain()
            if losses:
                _check_finite(_mean(losses), state.step, anomaly)
            cur["epoch"], cur["batch"] = epoch + 1, 0  # the next epoch's start
            if cfg.validation_files:
                with monitor.suspended():  # no train call completes here
                    val_auc = _evaluate(cfg, model, predict_step, state, cfg.validation_files,
                                        max_nnz, device, log)
                log(f"epoch {epoch} validation auc {val_auc:.5f}")
                monitor.emit("validation", step=state.step, epoch=epoch,
                             validation_auc=round(val_auc, 6))
                monitor.on_dispatch(state.step, warmup=(epoch == start_epoch))
            if cfg.save_every_epochs and (epoch + 1) % cfg.save_every_epochs == 0:
                with monitor.suspended():
                    ckpt.save_boundary(state, saveable, state.step)
                log(f"epoch {epoch} checkpoint -> {cfg.model_file}")
        # The stop save too: never a poisoned state.
        groups.drain()
        if losses:
            _check_finite(_mean(losses), state.step, anomaly)
    finally:
        restore_handlers()
        # Join the in-flight async write BEFORE the final save below: an
        # older publish must never land after a newer one.
        ckpt.finalize()
        summary = ckpt.summary()
        if ledger is not None:
            summary.update(ledger.summary())
        if datastats is not None:
            summary.update(datastats.summary())
        profiler.close(state.step)
        tracer.close()
        monitor.close(**summary)
    # The last save is synchronous whatever async_save says: when this
    # returns, the state on disk is the state returned.
    ckpt.save_boundary(state, saveable, state.step, sync=True, emit=False)
    if stop.is_set():
        log(
            f"stopped on signal at step {state.step}, model -> {cfg.model_file} "
            "(resume with --resume)"
        )
    else:
        log(f"training done: steps {start_step}->{state.step}, model -> {cfg.model_file}")
    return state
