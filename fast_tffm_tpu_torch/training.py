"""The training entry points — the counterpart of ``fast_tffm_tpu/training.py``
``train`` + ``_run_training`` (single device) and ``dist_train`` (the mesh
of ranks on ``torch.distributed``, ``parallel/``; see its docstring).

  train(cfg, resume=False, log=print, device=None, step_hook=None) -> TrainState
  dist_train(cfg, resume=False, log=print, device=None, mesh=None, step_hook=None)

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

``[Online] follow = true``: the one train file is an FMS stream that
another process appends to (``data/stream.py``); at EOF the reader polls
for growth instead of ending the epoch, until ``idle_timeout_s`` of
silence, ``max_batches`` or a stop signal, and the run's cursor names the
batch offset in the stream (``follow``: true, ``files``: the stream's prefix
fingerprint).  ``accum_restart_steps`` N resets every Adagrad accumulator
to its init value after the call that crosses each absolute multiple of N.

A log line every ``log_every`` steps (mean loss, examples/sec, in the JAX
package's wording; K-step aligned), a non-finite loss check at every log
point and epoch end before any save (under ``on_nan = abort`` also on every
K-step group, one group late, so the host does not wait on the group it
just launched), the validation AUC over ``validation_files`` and a save
every ``save_every_epochs`` epochs; the final state is saved and returned.
``device`` None means the card.

``on_nan = rollback``: a non-finite loss at a log point or epoch end
restores the last checkpoint (its delta chain included) into the live
tensors and runs again from the detection point's cursor, so the window
that diverged is skipped, not replayed (at most ``max_rollbacks`` times; a
run with no checkpoint yet raises).  An armed fault plan
(``resilience.install_faults``) poisons the host-side loss of its ``nan``
steps, kills at its ``kill`` steps through ``step_hook`` and fires its IO
and checkpoint faults in the reader and the writer; fault events drain
into kind=fault records at every log point and ``fault_*`` counters on the
summary.

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
rows between them; the stop and final saves stay synchronous.

The packed wire (``[Train] wire_format = packed``, the default) on streamed
FMB input at ``steps_per_call`` > 1 (at K = 1 the loop converts: see
``_wire_converter``): a second prefetch thread, behind the one that reads,
packs each
batch or K-group into one pinned buffer (``data/wire.py``), copies it to
the card and unpacks it there on a side stream; the loop's stream waits on
that work before the step.  The values are the arrays path's bit for bit;
``arrays`` copies each tensor.

``[ParamStore] enabled = true`` (``_tiered_train``): the table lives in a
host cold store (``paramstore/``) and the device holds a compact table of
``hot_rows`` resident rows plus ``miss_rows`` staging rows.  The prefetch
thread resolves each call's ids and ships its missed rows in the batch's
one buffer; the step stages them, runs the unchanged train step over the
compact table and writes them back; every save spans both tiers
(``checkpoint_async``); validation scores hot rows off the live table and
missed rows from a side tensor; kind=tiering records at every log point.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal
import threading

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import latest_step, read_input_cursor, restore_checkpoint
from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer
from fast_tffm_tpu_torch.config import Config, build_model
from fast_tffm_tpu_torch.data.binary import (
    ensure_fmb_cache,
    fmb_wire_flags,
    fold_epoch_seed,
    is_fmb,
)
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.data.native import best_parser
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.data.stream import (
    fms_follow_stream,
    is_fms,
    stream_prefix_fingerprint,
    stream_prefix_matches,
)
from fast_tffm_tpu_torch.data.wire import WireConverter, make_spec
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.distributed import host_metrics_path
from fast_tffm_tpu_torch.metrics import StreamingAUC, Throughput
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.profiling import (
    CostLedger,
    DataStatsCollector,
    StepProfiler,
    modeled_step_bytes,
)
from fast_tffm_tpu_torch.resilience import (
    NonFiniteLossError,
    active_faults,
    drain_fault_counters,
    drain_fault_events,
)
from fast_tffm_tpu_torch.telemetry import RunMonitor
from fast_tffm_tpu_torch.trainer import (
    init_packed_state,
    init_state,
    make_accum_restart,
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

__all__ = ["train", "dist_train", "binary_input", "NonFiniteLossError"]


def _check_finite(loss: float, step: int, anomaly=None, cursor=None) -> None:
    """Raise on a non-finite loss instead of training on (and eventually
    checkpointing) poisoned state.  ``anomaly(step, loss)`` records the
    divergence (a kind=anomaly record) before the raise; the error carries
    the input ``cursor`` at detection, where ``on_nan = rollback`` resumes
    the input."""
    if not np.isfinite(loss):
        if anomaly is not None:
            anomaly(step, loss)
        raise NonFiniteLossError(
            f"training loss is {loss}; likely a diverged model — lower "
            "learning_rate.  Aborting before the next checkpoint overwrites "
            "the last good state.",
            step=int(step),
            loss=float(loss),
            cursor=cursor,
        )


class _GroupCheck:
    """The finite check on each K-step group's losses, one group late.
    ``push`` starts copying a group's [K] losses to the host behind it on
    the card's stream and then checks the group before it, whose copy the
    card has finished or is about to: the host never waits on the group
    it just launched, so it builds the next while the card runs.  The
    check is never inside a captured graph.  ``drain`` checks the last
    group (at log points and before a save).  A K = 1 step's 0-d loss is
    left to the log-point check, as in the JAX package.  Disabled
    (``on_nan = rollback``) it checks nothing: the log point and the epoch
    end decide, with their cursors, the JAX package's skip positions."""

    def __init__(self, device, anomaly=None, enabled: bool = True):
        self._cuda = device.type == "cuda"
        self._anomaly = anomaly
        self._enabled = enabled
        self._last = None  # (host losses, copy event or None, step after the group)

    def push(self, loss: torch.Tensor, step: int) -> None:
        last, self._last = self._last, None
        if loss.dim() and self._enabled:
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


def _resolve_cursor(cfg: Config, cursor, log, process_index: int = 0,
                    process_count: int = 1) -> tuple[int, int]:
    """(start_epoch, start_batch) from a restored input cursor — the JAX
    ``_resolve_cursor``.

    A cursor that does not describe this run's input (batch size, shuffle
    and its seed, follow or not, the train files' fingerprint), or one of
    a newer version, starts at (0, 0) with a warning.  Under ``[Online]
    follow`` a follow cursor's ``files`` is the stream's prefix
    fingerprint: a stream whose prefix changed since the save (replaced,
    rewritten, truncated) raises, since starting again would retrain the
    whole stream; a batch run's cursor starts at (0, 0) with the warning.  A cursor at or past
    ``epoch_num`` is a completed run: resume then trains ``epoch_num``
    more epochs from (0, 0), unless it is ``_exact`` (a literal position:
    ``(epoch_num, 0)``, no input left).  A ``hosts`` vector (a
    multi-process save: one entry per rank) resolves to this rank's entry
    (``process_index`` of ``process_count``); a vector saved by another
    number of processes, or one whose entries disagree, takes the warned
    start, as in the JAX package."""
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
        if (saved_pcount or len(hosts)) != process_count or process_index >= len(hosts):
            log(
                "warning: checkpoint cursor vector was saved by "
                f"{saved_pcount or len(hosts)} host(s), this run has "
                f"{process_count} — resuming at the start of the data (legacy "
                "behavior)"
            )
            return 0, 0
        entries = [((h or {}).get("epoch"), (h or {}).get("batch_in_epoch")) for h in hosts]
        if any(e != entries[0] for e in entries[1:]):
            log(
                "warning: checkpoint cursor vector disagrees across hosts "
                f"({entries}) — resuming at the start of the data (legacy "
                "behavior)"
            )
            return 0, 0
        mine = hosts[process_index] or {}
        if mine.get("epoch") is not None:
            cursor["epoch"] = int(mine["epoch"])
            cursor["batch_in_epoch"] = int(mine.get("batch_in_epoch") or 0)
    follow = bool(cfg.online_follow)
    if follow and cursor.get("follow"):
        if cursor.get("files") is not None and not stream_prefix_matches(
            cfg.train_files, cursor["files"]
        ):
            raise ValueError(
                "online resume: the train stream's PREFIX changed since "
                "this cursor was saved (file replaced/rewritten/truncated, "
                "not appended?) — the saved batch offset no longer names "
                "the same data.  Start fresh (drop --resume) or restore "
                "the original stream file."
            )
        # The re-hash is the check: a grown stream's fingerprint differs.
        want_files = cursor.get("files")
    elif follow:
        want_files = object()  # a batch run's cursor never matches a stream
    else:
        want_files = _files_fingerprint(cfg.train_files)
    mismatched = [
        f"{key} {cursor.get(key)!r} != {want!r}"
        for key, want in (
            ("batch_size", int(cfg.batch_size)),
            ("shuffle", bool(cfg.shuffle)),
            ("shuffle_seed", int(cfg.shuffle_seed) if cfg.shuffle else cursor.get("shuffle_seed")),
            ("follow", follow if "follow" in cursor else follow or None),
            ("files", want_files),
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
            steps_per_call: int = 1, log=print, skip_batches: int = 0, dedup_cap: int = 0,
            convert=None, batch_size: int | None = None, shard: dict | None = None,
            pad_to_batches: int | None = None, wait_for_peer: float = 0.0):
    """One prefetched pass over ``files`` (an ``InputStream``: its stats feed
    kind=input records): (ParsedBatch, weights) pairs, or K-long lists of
    them when ``steps_per_call`` > 1.  Text parses through
    the native parser; ``binary_cache`` resolves the FMB caches first (an
    unwritable location falls back to the text, and a shuffle on that
    fallback is dropped with a log line); ``shuffle_epoch`` (train streams)
    folds the epoch into ``shuffle_seed``.  ``skip_batches`` opens the
    pass at that batch (the resume seek); ``dedup_cap`` > 0 checks each
    batch's unique ids against it before the batch ships.
    ``convert(files, depth)`` (given the resolved files and the queue depth)
    returns a converter for the prefetch threads, or None; with one, the
    items are ``(value, examples)`` (``_prefetched``).  A rank of a
    multi-process run passes its ``batch_size`` (B / P), its ``shard``
    (``shard_index``, ``shard_count``, ``shard_block``), the epoch's
    ``pad_to_batches`` and the cache build's ``wait_for_peer``."""
    files = tuple(files)
    parser = best_parser(cfg.thread_num)
    bs = cfg.batch_size if batch_size is None else int(batch_size)
    if cfg.binary_cache:
        files = ensure_fmb_cache(
            files, vocabulary_size=cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
            max_nnz=max_nnz, parser=parser, log=log, wait_for_peer=wait_for_peer,
        )
    shuffle_seed = (
        fold_epoch_seed(cfg.shuffle_seed, shuffle_epoch)
        if cfg.shuffle and shuffle_epoch is not None
        else None
    )
    if shuffle_seed is not None and cfg.binary_cache and not binary_input(files):
        if shard and shard.get("shard_count", 1) > 1:
            # The fallback is per process: one rank streaming its shard in
            # file order while its peers follow the permutation would
            # assemble global batches from different row orders.
            raise RuntimeError(
                "shuffle with binary_cache on a multi-process run: this process could "
                "not build/reach the binary cache (text fallback), and a per-host "
                "shuffle fallback would silently misalign the global batches — fix the "
                "cache location on every host (or pre-convert the files, or disable "
                "shuffle)"
            )
        log("shuffle disabled: the binary cache is unavailable (text fallback) and "
            "text streaming cannot reorder rows")
        shuffle_seed = None
    raw = batch_stream(
        files,
        batch_size=bs,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        max_nnz=max_nnz,
        weights=weights,
        parser=parser,
        shuffle_seed=shuffle_seed,
        skip_rows=skip_batches * bs,
        io_retries=cfg.io_retries,
        io_retry_backoff_s=cfg.io_retry_backoff_s,
        log=log,
        pad_to_batches=pad_to_batches,
        **(shard or {}),
    )
    if dedup_cap > 0:
        raw = _dedup_cap_guard(raw, dedup_cap)
    depth = _depth(cfg, steps_per_call)
    return _prefetched(cfg, raw, steps_per_call,
                       convert=convert(files, depth) if convert is not None else None)


def _depth(cfg: Config, steps_per_call: int) -> int:
    """The prefetch queue's depth: an item holds K batches, so the depth is
    scaled down to keep the memory in flight at the K = 1 level."""
    return max(1, cfg.queue_size // max(1, steps_per_call))


def _prefetched(cfg: Config, raw, steps_per_call: int, idle=None, convert=None):
    """``raw`` grouped into K-lists when ``steps_per_call`` > 1 and run in
    the prefetch thread, as an ``InputStream``; ``idle`` (a followed
    stream's Event) feeds the stall watchdog's stream-idle probe.  With
    ``convert`` a second thread converts each item (pack, H2D and unpack
    on a side stream), so reading and converting overlap; the stream then
    yields ``(value, examples)``, the loop's stream waiting for each
    value's device work as it is taken (``Staged.ready``)."""
    if steps_per_call > 1:
        raw = grouped_pairs(raw, steps_per_call)
    stats = InputStats()
    if idle is not None:
        stats.bind_stream_idle(idle)
    depth = _depth(cfg, steps_per_call)
    if convert is None:
        return InputStream(prefetch(stats.timed(raw), depth=depth, stats=stats), stats)
    made = prefetch(stats.produced(raw), depth=depth)
    staged = prefetch(stats.converting(made, convert), depth=depth, stats=stats,
                      name="input-convert")
    return InputStream(((s.ready(), ex) for s, ex in staged), stats, converted=True)


def _wire_converter(cfg: Config, model, max_nnz: int, device, weights):
    """``convert`` of ``_stream`` for the train stream: under ``wire_format =
    packed`` an FMB stream at ``steps_per_call`` > 1 ships on the packed wire
    (``WireConverter``, its pinned ring one buffer deeper than the queue).
    What is left out is decided per stream from facts about its files:
    all-ones vals from the FMB v2 header flags (checked again per batch by
    the packer), fields by the model's ``uses_fields``, weights when every
    file weight is 1.0.  Text input, ``arrays`` and K = 1 convert in the
    loop: the eager K = 1 loop is bound by its own Python, which a
    converting thread slows more than its one H2D saves; a K-step graph
    leaves the loop thread waiting, and there the wire wins."""

    def make(files, depth):
        if (cfg.wire_format != "packed" or cfg.steps_per_call == 1
                or not binary_input(files) or not max_nnz):
            return None
        all_ones, _ = fmb_wire_flags(files)
        uniform = weights is None or all(float(x) == 1.0 for x in weights)
        spec = make_spec(cfg.vocabulary_size, max_nnz, with_vals=not all_ones,
                         with_fields=model.uses_fields, with_weights=not uniform)
        return WireConverter(spec, device, slots=depth + 1)

    return make


def _follow_stream(cfg: Config, files, max_nnz: int, skip_batches: int = 0, stop=None):
    """The input of ``[Online] follow = true``: ``fms_follow_stream`` over
    the one FMS train file in the prefetch thread, grouped into K-lists when
    ``steps_per_call`` > 1 (a group the stream's end cuts short comes out
    short, as ``grouped_pairs`` makes it).  The stream's idle Event feeds the
    stall watchdog (input-starved (stream-idle)); ``skip_batches`` is the
    resume seek, one file seek; ``stop`` ends the stream at its next poll
    (the signal handler sets it, so an idle, unbounded stream still takes
    the stop-and-save path)."""
    idle = threading.Event()
    raw = fms_follow_stream(
        files[0],
        batch_size=cfg.batch_size,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        max_nnz=max_nnz,
        poll_s=cfg.online_poll_s,
        idle_timeout_s=cfg.online_idle_timeout_s,
        max_batches=cfg.online_max_batches,
        skip_batches=skip_batches,
        idle_flag=idle,
        stop=stop,
    )
    return _prefetched(cfg, raw, cfg.steps_per_call, idle=idle)


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


def _tiered_train(cfg: Config, *, resume: bool, log, device, step_hook):
    """``[ParamStore]``: local training over the two-tier parameter store
    (the JAX ``_tiered_train``).  The step is the UNCHANGED train step over
    the compact [C, D] table (its tail kernel B4 on the card, over slot
    ids); around it the prefetch thread resolves each call
    (``paramstore.TieredConverter``: the remap, the missed rows read through
    the pending overlay, one buffer on the packed wire spec'd at the
    capacity C), the step stages and writes back the missed rows
    (``TieredParamServer.wrap_step``), and every save spans both tiers.  The
    prefetch thread converts text input too (the JAX package converts text
    in the loop thread), so its resolution always runs ahead."""
    from fast_tffm_tpu_torch.paramstore import TieredConverter, open_tiered_run

    model = build_model(cfg)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    server, state, start_cursor = open_tiered_run(cfg, model, max_nnz, resume=resume,
                                                  device=device, log=log)
    body = make_decayed_body(cfg.online_adagrad_decay)
    k = cfg.steps_per_call
    step_fn = server.wrap_step(
        (make_scanned_train_step if k > 1 else make_train_step)(model, cfg.learning_rate,
                                                                 body=body))
    # The wire is spec'd at the compact capacity: ids narrow to the slot range.
    spec = make_spec(server.capacity, max_nnz, with_vals=True, with_fields=model.uses_fields,
                     with_weights=True)
    weights = cfg.weight_files or None

    def convert(_files, depth):
        return TieredConverter(server, spec, device, slots=depth + 1)

    def train_stream(epoch, skip_batches=0):
        return _stream(cfg, cfg.train_files, max_nnz, weights, shuffle_epoch=epoch,
                       steps_per_call=k, log=log, skip_batches=skip_batches, convert=convert)

    def evaluate(st):
        # Hot rows off the live compact table, missed rows from a side
        # tensor: the train state is not touched.
        server.flush_writeback(st)
        meter = StreamingAUC()
        for parsed, w in _stream(cfg, cfg.validation_files, max_nnz, log=log):
            meter.add(parsed.labels, server.predict(st, parsed, w).cpu().numpy(), w)
        return meter.value()

    return _run_training(
        cfg, state, model=model, device=device, step_fn=step_fn, train_stream=train_stream,
        ids_of=lambda tb: tb.ids, predict_step=None, max_nnz=max_nnz, log=log,
        step_hook=step_hook, accum_restart=None, stream_stop=None, start_cursor=start_cursor,
        paramstore=server, evaluate=evaluate,
    )


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


def _signal_stop(log, on_stop=None):
    """(stop event, restore) for the first-signal stop: SIGTERM and SIGINT
    set the event, call ``on_stop()`` (a followed stream's end) and put
    back their previous handler, so a second signal takes it.  Installed on
    the main thread only (``signal.signal`` works nowhere else);
    ``restore()`` reinstates the previous handlers."""
    stop = threading.Event()
    previous = {}

    def on_signal(signum, frame):
        log(f"received signal {signum}: checkpointing after current step")
        stop.set()
        if on_stop is not None:
            on_stop()
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


def _to_batches(src: InputStream, model, device) -> InputStream:
    """A (ParsedBatch or K-list, weights) stream as (Batch, examples): a
    K-list stacks into one host superbatch (the K-step call copies it to
    the card), a batch goes to ``device``.  A stream converted in the
    prefetch threads (``_prefetched``) is that already."""
    if src.converted:
        return src

    def batches():
        for parsed, w in src:
            if isinstance(parsed, list):
                yield (Batch.stack_parsed(parsed, w, with_fields=model.uses_fields),
                       sum(p.batch_size for p in parsed))
            else:
                yield (Batch.from_parsed(parsed, w, device, with_fields=model.uses_fields),
                       parsed.batch_size)

    return InputStream(batches(), src.stats)


def _restore_into(state, restored) -> None:
    """Copy a restored state into the live one's tensors (``copy_``): their
    storage stays, so a captured CUDA graph of K steps replays on the
    restored values and no second capture is made."""
    with torch.no_grad():
        for live, new in ((state.table, restored.table),
                          (state.table_accum, restored.table_accum),
                          *zip(state.dense, restored.dense),
                          *zip(state.dense_accum, restored.dense_accum)):
            if live is not None:
                live.copy_(new)
    state.step = restored.step


def train(cfg: Config, *, resume: bool = False, log=print, device=None, step_hook=None):
    """Local (single-device) training — the reference's ``train`` mode.

    ``resume`` restores ``cfg.model_file`` (table, accumulators, step; the
    delta chain replayed) and reopens the input at its cursor; otherwise
    the state is a fresh init from a seeded generator.  ``step_hook(step)``
    runs after every call, before the stop check (a test raises SIGTERM
    from it at an exact step; an armed fault plan's kills ride it).
    Returns the final state in the layout it trained in (a packed or fused
    state for ``table_layout = packed``); its logical arrays are saved to
    ``cfg.model_file`` with the cursor.  Under ``on_nan = rollback`` a
    non-finite loss restores the last checkpoint into the live state and
    runs again from the detection point's cursor (see the module
    docstring)."""
    if not cfg.train_files:
        raise ValueError("no train_files configured")
    if cfg.weight_files and len(cfg.weight_files) != len(cfg.train_files):
        raise ValueError(
            f"weight_files has {len(cfg.weight_files)} entries for "
            f"{len(cfg.train_files)} train_files (they align per-file)"
        )
    if cfg.online_follow:
        if len(cfg.train_files) != 1:
            raise ValueError(
                "[Online] follow = true takes exactly ONE train file (an "
                f"append-only FMS stream), got {len(cfg.train_files)}"
            )
        if not is_fms(cfg.train_files[0]):
            raise ValueError(
                f"[Online] follow = true needs an FMS stream file; "
                f"{cfg.train_files[0]!r} is not one (create and append "
                "with fast_tffm_tpu_torch.data.stream.StreamWriter)"
            )
    device = resolve_device(device)
    if cfg.paramstore:
        # Tables beyond the card's memory: a branch of its own, since the
        # input path, the step, validation and every save are residency-aware.
        return _tiered_train(cfg, resume=resume, log=log, device=device, step_hook=step_hook)
    model = build_model(cfg)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    packed = cfg.table_layout == "packed"
    fused = packed and cfg.adagrad_accumulator == "fused"
    accum_width = model.row_dim if cfg.adagrad_accumulator == "element" else 1

    def restore_state():
        """``model_file`` in this run's layout: the logical arrays first,
        packed after (never a fresh packed state beside them).  Shared by
        ``resume`` and the rollback."""
        restored = restore_checkpoint(cfg.model_file, device, n_dense=len(model.dense_names),
                                      accum_width=accum_width)
        if restored.table.shape != (model.vocabulary_size, model.row_dim):
            raise ValueError(
                f"checkpoint {cfg.model_file!r} holds a {tuple(restored.table.shape)} table; "
                f"this config trains [{model.vocabulary_size}, {model.row_dim}]"
            )
        if packed:
            restored = pack_state(restored, cfg.init_accumulator_value, fused=fused)
        return restored

    start_cursor = None
    if resume:
        state = restore_state()
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
    # One stop Event per followed stream, in a one-slot holder: the signal
    # handler sets the live stream's, and a stream a rollback abandoned
    # keeps its own (set) one.
    stream_stop = [threading.Event()] if cfg.online_follow else None
    if cfg.device_cache:
        step_fn, train_stream, ids_of = _device_cached_input(cfg, model, max_nnz, log, body,
                                                             device)
    else:
        step_fn = (make_scanned_train_step if k > 1 else make_train_step)(
            model, cfg.learning_rate, body=body
        )
        weights = cfg.weight_files or None

        def train_stream(epoch, skip_batches=0):
            if cfg.online_follow:
                stream_stop[0] = threading.Event()
                src = _follow_stream(cfg, cfg.train_files, max_nnz, skip_batches,
                                     stop=stream_stop[0])
            else:
                src = _stream(cfg, cfg.train_files, max_nnz, weights, shuffle_epoch=epoch,
                              steps_per_call=k, log=log, skip_batches=skip_batches,
                              dedup_cap=cfg.dedup_gather_rows,
                              convert=_wire_converter(cfg, model, max_nnz, device, weights))
            return _to_batches(src, model, device)

        def ids_of(batch):
            # A K-step call's superbatch is on the host; its graph's static
            # buffers hold the same ids on the card.
            return step_fn.last_batch().ids if k > 1 else batch.ids

    accum_restart = (make_accum_restart(cfg.init_accumulator_value)
                     if cfg.online_accum_restart_steps > 0 else None)
    run = dict(model=model, device=device, step_fn=step_fn, train_stream=train_stream,
               ids_of=ids_of, predict_step=predict_step, max_nnz=max_nnz, log=log,
               step_hook=step_hook, accum_restart=accum_restart, stream_stop=stream_stop)
    # on_nan = rollback: restore the last checkpoint and resume the input at
    # the detection cursor, skipping the window that diverged (at most
    # max_rollbacks times; abort, or no checkpoint yet, raises).
    rollbacks = 0
    rollback_note = None
    while True:
        try:
            return _run_training(cfg, state, start_cursor=start_cursor, rollback=rollback_note,
                                 **run)
        except NonFiniteLossError as e:
            if (
                cfg.on_nan != "rollback"
                or rollbacks >= cfg.max_rollbacks
                or e.cursor is None
                or latest_step(cfg.model_file) is None
            ):
                raise
            rollbacks += 1
            # The failed run's finally joined its in-flight async save, so the
            # chain head read here is the newest one published.
            _restore_into(state, restore_state())
            start_cursor = dict(e.cursor, _exact=True)
            rollback_note = {
                "step": e.step,
                "loss": e.loss,
                "rollback_n": rollbacks,
                "restored_step": int(state.step),
                "skip_to_epoch": int(e.cursor.get("epoch", 0)),
                "skip_to_batch": int(e.cursor.get("batch_in_epoch", 0)),
            }
            log(
                f"on_nan = rollback: non-finite loss at step {e.step}; "
                f"restored {cfg.model_file} (step {int(state.step)}), "
                f"skipping input to epoch {rollback_note['skip_to_epoch']} "
                f"batch {rollback_note['skip_to_batch']} "
                f"(rollback {rollbacks}/{cfg.max_rollbacks})"
            )


def _run_training(cfg: Config, state, *, model, device, step_fn, train_stream, ids_of,
                  predict_step, max_nnz: int, log, step_hook, accum_restart, stream_stop,
                  start_cursor=None, rollback=None, paramstore=None, evaluate=None,
                  saveable=None, runtime=None, chips: int = 1, extra_metrics=None,
                  touched_rows=None):
    """The step loop of one run over ``state`` (the JAX ``_run_training``):
    entered once, and again after each rollback with the restored state,
    ``start_cursor`` the detection point's (``_exact``) and ``rollback``
    the note the new run records as kind=anomaly event=rollback.
    ``train_stream(epoch, skip_batches)`` opens an epoch's input at a
    batch; ``ids_of(batch)`` gives a call's ids; ``accum_restart`` (or
    None) resets the accumulators; ``stream_stop`` is a followed stream's
    stop holder (or None).  A tiered run passes its ``paramstore`` (the
    saves span both tiers, kind=tiering records) and ``evaluate(state)``,
    its validation AUC.  A distributed run (``dist_train``) passes its
    ``saveable`` (the logical state gathered onto rank 0), its ``runtime``
    (the checkpoints' single-writer protocol, one run id, the per-rank
    metrics path and cursor entry), its ``chips`` (the world size, for the
    per-chip rate), ``extra_metrics()`` (the alltoall overflow count,
    drained into every kind=train record and the summary), and for delta
    saves its ``touched_rows`` (the mesh's gather of a delta's rows).  The
    runtime's heartbeat carries the step, and
    with more than one process, a ``runtime_dir`` and ``host_stall_timeout_s``
    > 0 a ``HostMonitor`` turns a stale peer into a kind=stall record."""
    k = cfg.steps_per_call
    rank, world = (runtime.process_index, runtime.process_count) if runtime else (0, 1)
    is_lead = rank == 0
    # The input cursor, tracked per call: every save embeds it.
    start_epoch, start_batch = _resolve_cursor(cfg, start_cursor, log, rank, world)
    cur = {"epoch": start_epoch, "batch": start_batch}
    # A followed stream grows: its identity is its prefix, not its size.
    files_fp = (stream_prefix_fingerprint(cfg.train_files) if cfg.online_follow
                else _files_fingerprint(cfg.train_files))

    def input_cursor() -> dict:
        c = {
            "version": 1,
            "epoch": cur["epoch"],
            "batch_in_epoch": cur["batch"],
            "batch_size": int(cfg.batch_size),
            "shuffle": bool(cfg.shuffle),
            "shuffle_seed": int(cfg.shuffle_seed),
            "steps_per_call": int(k),
            "files": files_fp,
        }
        if cfg.online_follow:
            c["follow"] = True
        return c

    cuda = device.type == "cuda"
    run_id = cfg.telemetry_run_id
    if runtime is not None and runtime.active and not run_id:
        # One run identity across the ranks: the lead draws it.
        from fast_tffm_tpu_torch.telemetry import new_run_id

        run_id = runtime.broadcast("run_id", new_run_id() if runtime.is_lead else None)
    # Each rank writes its own telemetry file (rank 0 the configured path).
    monitor = RunMonitor(
        host_metrics_path(cfg.metrics_path, rank) or None, run_id=run_id, source="train",
        stall_timeout_s=cfg.telemetry_stall_timeout_s, mem_every_s=cfg.telemetry_mem_every_s,
        device=device, log=log,
    )
    # Rank 0 owns the traces.
    tracer = WindowTracer(cfg.trace_dir if is_lead else "", count=cfg.trace_steps, cuda=cuda)
    profiler = StepProfiler(cfg.telemetry_profile_steps if is_lead else "",
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
    if saveable is None:
        saveable = lambda st: unpack_state(st, model)  # noqa: E731
    ckpt = AsyncCheckpointer(
        cfg.model_file, device=device, monitor=monitor, log=log,
        chunk_bytes=cfg.checkpoint_chunk_mb << 20, async_save=cfg.async_save,
        delta_every_steps=cfg.delta_every_steps, delta_chain_max=cfg.delta_chain_max,
        full_every_s=cfg.delta_full_every_s, chain_max_bytes=cfg.delta_chain_max_bytes,
        # A tiered run's touched-row bitmap is over the compact table's slots.
        vocab=paramstore.capacity if paramstore is not None else cfg.vocabulary_size,
        row_dim=model.row_dim, start_step=state.step, cursor_fn=input_cursor,
        paramstore=paramstore, runtime=runtime, touched_rows=touched_rows,
    )
    if evaluate is None:
        def evaluate(st):
            return _evaluate(cfg, model, predict_step, st, cfg.validation_files, max_nnz,
                             device, log)

    def emit_tiering(epoch):
        if paramstore is not None and (
                rec := paramstore.stats.drain(paramstore.pending_rows, paramstore.hot_rows)):
            monitor.emit("tiering", step=state.step, epoch=epoch, **rec)

    def anomaly(step, loss):
        monitor.emit_anomaly(step, loss, state=state)

    if rollback is not None:
        # The failed run recorded the non-finite loss; this records the
        # recovery (restored step, skip position, rollback ordinal).
        monitor.emit_anomaly(
            int(rollback.get("step", 0)), rollback.get("loss"), event="rollback",
            **{key: v for key, v in rollback.items() if key not in ("step", "loss")},
        )
    # Pod liveness: the heartbeat armed at bring-up carries the step, and a
    # peer's stale heartbeat is a host-level kind=stall record.
    heartbeat = getattr(runtime, "heartbeat", None)
    host_monitor = None
    if (runtime is not None and world > 1 and runtime.runtime_dir
            and cfg.host_stall_timeout_s > 0):
        from fast_tffm_tpu_torch.distributed import HostMonitor

        def on_host_stall(peer, classification, detail):
            monitor.emit("stall", step=state.step, deadline_s=cfg.host_stall_timeout_s,
                         since_last_step_s=detail.get("age_s"), classification=classification,
                         prefetch_queue_depth=None, stacks={}, peer=peer,
                         peer_last_step=detail.get("last_step"))

        host_monitor = HostMonitor(runtime.runtime_dir, rank, world, cfg.host_stall_timeout_s,
                                   on_host_stall, poll_s=min(1.0, cfg.host_stall_timeout_s / 4.0))
    faults = active_faults()  # None unless a fault plan is armed
    start_step = state.step
    # The accumulator restarts sit on absolute multiples of N, so a resumed
    # run resets at the steps the uninterrupted one does; K-aligned: after
    # the first call that reaches a multiple.
    restart_n = max(1, int(cfg.online_accum_restart_steps))
    next_restart = (start_step // restart_n + 1) * restart_n if accum_restart else None
    meter = Throughput()
    losses: list[torch.Tensor] = []  # device values; synced at log points
    groups = _GroupCheck(device, anomaly, enabled=cfg.on_nan == "abort")
    pending = 0  # steps since the last log point
    counted = 0  # examples the meter holds

    def emit_faults():
        for ev in drain_fault_events():
            monitor.emit("fault", step=state.step, **ev)

    stop, restore_handlers = _signal_stop(
        log, on_stop=(lambda: stream_stop[0].set()) if stream_stop else None)
    try:
        for epoch in range(start_epoch, cfg.epoch_num):
            if stop.is_set():
                break
            # A resumed first epoch reopens at the cursor's batch.
            epoch_stream = train_stream(epoch, cur["batch"] if epoch == start_epoch else 0)
            input_stats = getattr(epoch_stream, "stats", None)
            monitor.set_queue_depth_fn(getattr(epoch_stream, "queue_depth", None))
            monitor.set_producer_alive_fn(getattr(epoch_stream, "producer_alive", None))
            monitor.set_stream_idle_fn(getattr(epoch_stream, "stream_idle", None))
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
                if heartbeat is not None:
                    heartbeat.set_step(state.step)
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
                if next_restart is not None and state.step >= next_restart:
                    next_restart = (state.step // restart_n + 1) * restart_n
                    state = accum_restart(state)
                if ckpt.delta_enabled:
                    ckpt.note_batch(ids_of(batch))
                    if ckpt.delta_due(state.step) and not stop.is_set():
                        with monitor.suspended():
                            ckpt.delta_boundary(state, saveable, state.step)
                losses.append(loss)
                if faults is not None and faults.nan_due(state.step):
                    # The fault plan poisons the loss the check reads, never
                    # the state.
                    losses[-1] = torch.full_like(loss, float("nan"))
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
                    _check_finite(mean_loss, state.step, anomaly, cursor=input_cursor())
                    emit_faults()
                    extra = extra_metrics() if extra_metrics is not None else {}
                    # A window that holds only the first call (K >= log_every)
                    # has no examples to rate: its line gives the loss alone.
                    log(
                        f"step {state.step} epoch {epoch} loss {mean_loss:.5f}"
                        + (f" examples/sec {rate:,.0f} (/chip {rate / chips:,.0f})"
                           if counted else "")
                        + "".join(f" {key} {v}" for key, v in extra.items() if v)
                    )
                    monitor.emit(
                        "train", step=state.step, epoch=epoch, loss=round(mean_loss, 6),
                        examples_per_sec=round(rate, 1) if counted else None,
                        examples_per_sec_per_chip=round(rate / chips, 1) if counted else None,
                        **extra,
                    )
                    if input_stats is not None and (rec := input_stats.drain()):
                        monitor.emit("input", step=state.step, epoch=epoch, **rec)
                    emit_tiering(epoch)
                    losses.clear()
                    meter.reset()
                    counted = 0
            if stop.is_set():
                break
            # The epoch is done: the cursor names the next epoch's start, the
            # position the save below embeds.  A followed stream's one epoch
            # never completes (the stream went quiet or hit its bound): its
            # cursor keeps the batch offset, where the next resume goes on.
            if not cfg.online_follow:
                cur["epoch"], cur["batch"] = epoch + 1, 0
            if input_stats is not None and (rec := input_stats.drain()):
                monitor.emit("input", step=state.step, epoch=epoch, **rec)
            emit_tiering(epoch)  # the epoch tail's window, as the input record's
            # A poisoned state must stop here, BEFORE the save below replaces
            # the last good checkpoint.  The whole unlogged window counts: an
            # injected nan poisons one entry of it.
            groups.drain()
            if losses:
                _check_finite(_mean(losses), state.step, anomaly, cursor=input_cursor())
            if cfg.validation_files:
                with monitor.suspended():  # no train call completes here
                    val_auc = evaluate(state)
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
            _check_finite(_mean(losses), state.step, anomaly, cursor=input_cursor())
    finally:
        restore_handlers()
        if stream_stop is not None:
            # A followed stream's producer stops on every way out.
            stream_stop[0].set()
        # Join the in-flight async write BEFORE the final save below (an
        # older publish must never land after a newer one) and before a
        # rollback reads the chain head.
        ckpt.finalize()
        summary = ckpt.summary()
        if extra_metrics is not None:
            summary.update({key: v for key, v in extra_metrics().items() if v})
        # The last window's fault events and the run's counters.
        emit_faults()
        summary.update({f"fault_{key}": v for key, v in drain_fault_counters().items() if v})
        if ledger is not None:
            summary.update(ledger.summary())
        if datastats is not None:
            summary.update(datastats.summary())
        if paramstore is not None:
            summary.update(paramstore.summary())
        profiler.close(state.step)
        tracer.close()
        if host_monitor is not None:
            host_monitor.close()
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


# ---------------------------------------------------------------------------
# dist_train: the mesh of ranks
# ---------------------------------------------------------------------------

def _dist_refusals(cfg: Config) -> None:
    """What ``dist_train`` does not run: the JAX package's refusals in its
    words."""
    if cfg.paramstore:
        raise ValueError(
            "[ParamStore] is local-train only; dist_train shards the "
            "table over the mesh instead (drop [ParamStore] enabled, or "
            "run `train`)"
        )
    if cfg.dedup_gather_rows > 0:
        raise ValueError(
            "dedup_gather_rows is local-train only (the sharded lookup "
            "collectives have their own dedup story)"
        )
    if cfg.online_follow:
        raise ValueError(
            "[Online] follow = true is single-process (train); dist_train "
            "cannot shard an append-only stream"
        )
    if cfg.online_accum_restart_steps > 0:
        raise ValueError(
            "[Online] accum_restart_steps is single-process (train) for "
            "now; use adagrad_decay on pods"
        )
    if cfg.device_cache and cfg.shuffle:
        raise ValueError(
            "device_cache with shuffle is local-train only; dist_train "
            "slices the resident epoch sequentially (drop shuffle, or "
            "pre-shuffle at convert time)"
        )


def _scaled(src: InputStream, factor: int) -> InputStream:
    """A rank's (batch, examples) stream counting the GLOBAL batch's
    examples, the JAX ``examples_per_step``."""
    if factor == 1:
        return src
    return InputStream(((b, ex * factor) for b, ex in src), src.stats, converted=True)


def dist_train(cfg: Config, *, resume: bool = False, log=print, device=None, mesh=None,
               step_hook=None):
    """Mesh-distributed training — the reference's ``dist_train`` mode, on
    ``torch.distributed``: ``[Distributed] num_processes`` copies of this
    program, one rank per process and device, over the ``[data, row]`` mesh
    of ranks (``parallel/``).  Each rank holds its row shard of the table,
    parses only its ``B / P`` rows of every global batch (block-cyclic line
    sharding, or ``input_assignment = files``), and the global line count,
    taken up front, fixes the steps of an epoch on every rank (a short
    shard pads with weight-0 batches).  Saves gather the logical state
    onto rank 0, which alone writes; ``resume`` gives every rank its rows
    of ``model_file`` and its entry of the saved cursor vector;
    ``on_nan = rollback`` restores after a barrier.  At world size 1 this is
    ``train`` step for step (the same stream, step and saves).

    ``device`` None means the card (rank r on ``cuda:<local index>``);
    ``mesh`` overrides the configured shape.  Returns the rank's final
    state (its shard)."""
    from fast_tffm_tpu_torch.checkpoint import read_delta_chain
    from fast_tffm_tpu_torch.data.native import count_lines
    from fast_tffm_tpu_torch.distributed import initialize_runtime
    from fast_tffm_tpu_torch.parallel import (
        check_batch_divides,
        gather_logical_state,
        gather_touched_rows,
        init_sharded_state,
        make_mesh,
        make_sharded_predict_step,
        make_sharded_train_step,
        shard_state,
    )
    from fast_tffm_tpu_torch.parallel.mesh import all_gather_cat
    from fast_tffm_tpu_torch.parallel.multihost import local_device
    from fast_tffm_tpu_torch.parallel.train_step import _layout

    if not cfg.train_files:
        raise ValueError("no train_files configured")
    if cfg.tail == "pallas":
        raise ValueError(
            "tail = pallas is not supported by dist_train yet (the "
            "sharded step keeps the XLA sparse tail); use tail = auto "
            "or xla for distributed runs"
        )
    if cfg.weight_files and len(cfg.weight_files) != len(cfg.train_files):
        raise ValueError(
            f"weight_files has {len(cfg.weight_files)} entries for "
            f"{len(cfg.train_files)} train_files (they align per-file)"
        )
    device = resolve_device(device)
    runtime = initialize_runtime(cfg, log=log, device=device)
    device = local_device(device)
    world, rank = runtime.process_count, runtime.process_index
    _dist_refusals(cfg)
    model = build_model(cfg)
    max_nnz = scan_max_nnz(cfg)
    cfg.check_width(max_nnz)
    if mesh is None:
        mesh = make_mesh(cfg.data_parallel or None, cfg.row_parallel or cfg.vocabulary_block_num)
    log(f"mesh: {mesh.shape} on {mesh.size} devices")
    check_batch_divides(cfg.batch_size, mesh)
    layout = _layout(cfg.table_layout, cfg.adagrad_accumulator)
    accum_width = model.row_dim if cfg.adagrad_accumulator == "element" else 1
    cpu = torch.device("cpu")

    def restore_state():
        """``model_file`` as this rank's shard in the run's layout: the
        logical arrays (delta chain replayed), re-padded to the mesh's
        vocabulary, cut to the shard, packed.  Shared by ``resume`` and the
        rollback."""
        logical = restore_checkpoint(cfg.model_file, device if world == 1 else cpu,
                                     n_dense=len(model.dense_names), accum_width=accum_width)
        if logical.table.shape[1] != model.row_dim:
            raise ValueError(
                f"checkpoint {cfg.model_file!r} holds a {tuple(logical.table.shape)} table; "
                f"this config trains rows of width {model.row_dim}"
            )
        st = shard_state(logical, model, mesh, cfg.init_accumulator_value, layout)
        if world > 1:
            st.table = st.table.to(device)
            st.table_accum = None if st.table_accum is None else st.table_accum.to(device)
            st.dense = [p.to(device) for p in st.dense]
            st.dense_accum = [a.to(device) for a in st.dense_accum]
        return st

    def chain_head():
        try:
            base_sig, chain = read_delta_chain(cfg.model_file)
            return chain[-1]["save_id"] if chain else base_sig
        except (ValueError, OSError):
            return None

    if resume and not os.path.isfile(cfg.model_file):
        log(f"warning: --resume but no checkpoint at {cfg.model_file} — "
            "starting fresh (crash before the first publish?)")
        resume = False
    start_cursor = None
    if resume:
        state = restore_state()
        log(f"resumed from {cfg.model_file} at step {state.step}")
        start_cursor = read_input_cursor(cfg.model_file)
        if start_cursor is None:
            log("note: checkpoint carries no input cursor (pre-resilience "
                "format) — input restarts at the first file (legacy resume)")
    else:
        state = init_sharded_state(model, mesh, torch.Generator(device=device).manual_seed(0),
                                   cfg.init_accumulator_value, cfg.adagrad_accumulator,
                                   cfg.table_layout)
    if runtime.active:
        # No rank enters the collectives until every rank holds the same
        # restored step, chain head and cursor.
        runtime.agree("restore", {
            "step": int(state.step), "head": chain_head() if resume else None,
            "cursor": [(start_cursor or {}).get("epoch"),
                       (start_cursor or {}).get("batch_in_epoch")],
        })
    step_kw = dict(
        lookup=cfg.lookup, capacity_factor=cfg.lookup_capacity_factor,
        overflow_mode=cfg.lookup_overflow, table_layout=cfg.table_layout,
        packed_update=cfg.packed_update, accumulator=cfg.adagrad_accumulator,
        compact_cap=cfg.packed_compact_cap, steps_per_call=cfg.steps_per_call,
        adagrad_decay=cfg.online_adagrad_decay,
    )
    predict_step = make_sharded_predict_step(
        model, mesh, lookup=cfg.lookup, capacity_factor=cfg.lookup_capacity_factor,
        overflow_mode=cfg.lookup_overflow, table_layout=cfg.table_layout,
        accumulator=cfg.adagrad_accumulator,
    )
    if world > 1:
        log("note: multi-process npz checkpoints — process 0 is the sole "
            "writer; peers barrier on each publish's content signature")
    k = cfg.steps_per_call
    weights = cfg.weight_files or None
    files = tuple(cfg.train_files)
    local_bs = cfg.batch_size // world
    shard = pad = None
    wait = cfg.binary_cache_wait if rank != 0 and cfg.input_assignment != "files" else 0.0
    if cfg.device_cache:
        # The resident epoch, each rank holding its rows of every batch on
        # its own device; the step gathers batch i there (no per-step H2D).
        from fast_tffm_tpu_torch.data.device_cache import (
            call_ids,
            epoch_index_chunks,
            load_sharded_device_dataset,
            make_cached_sharded_train_step,
        )

        if cfg.binary_cache:
            files = ensure_fmb_cache(
                files, vocabulary_size=cfg.vocabulary_size, hash_feature_id=cfg.hash_feature_id,
                max_nnz=max_nnz, parser=best_parser(cfg.thread_num), log=log,
                wait_for_peer=wait,
            )
        if not binary_input(files):
            raise ValueError(
                "device_cache = true needs FMB-backed input: list .fmb "
                "files in train_files, or set binary_cache = true"
            )
        data = load_sharded_device_dataset(
            files, mesh=mesh, batch_size=cfg.batch_size, vocabulary_size=cfg.vocabulary_size,
            hash_feature_id=cfg.hash_feature_id, max_nnz=max_nnz, weights=weights,
            with_fields=model.uses_fields, device=device,
        )
        log(f"device cache: {data.n_rows} rows resident, sharded over {mesh.size} devices "
            f"({data.nbytes * mesh.size / 2**20:.1f} MiB total, {data.batches} batches/epoch)")
        step_fn = make_cached_sharded_train_step(model, cfg.learning_rate, mesh, data, **step_kw)

        def ids_of(i):
            return call_ids(data, i, False)

        items = (epoch_index_chunks(data.batches, k, device) if k > 1 else
                 [torch.tensor(i, dtype=torch.int64, device=device)
                  for i in range(data.batches)])

        def train_stream(epoch, skip_batches=0):
            use = items
            if skip_batches:
                use = (epoch_index_chunks(data.batches, k, device, start=skip_batches) if k > 1
                       else items[skip_batches:])
            # Each call trains i.numel() GLOBAL batches.
            return ((i, cfg.batch_size * i.numel()) for i in use)
    else:
        step_fn = make_sharded_train_step(model, cfg.learning_rate, mesh, **step_kw)
        if world > 1 and cfg.input_assignment == "files":
            # Shard-disjoint files: rank p streams files [p::P] whole; the
            # per-rank row counts meet through the runtime.
            if len(files) < world:
                raise ValueError(
                    f"input_assignment = files needs at least one train "
                    f"file per process ({len(files)} files, {world} "
                    "processes) — split the dataset or use "
                    "input_assignment = rows"
                )
            files = files[rank::world]
            weights = tuple(cfg.weight_files)[rank::world] if cfg.weight_files else None
            per_rank = [int(r) for r in runtime.allgather("files-rows", count_lines(files))]
            pad = max(-(-r // local_bs) for r in per_rank)
            log(f"input sharding: shard-disjoint files — host {rank} owns {len(files)} "
                f"file(s) / {per_rank[rank]} rows, {pad} steps/epoch, {local_bs} "
                "rows/process/step")
        elif world > 1:
            total = count_lines(cfg.train_files)
            pad = -(-total // cfg.batch_size)
            shard = dict(shard_index=rank, shard_count=world, shard_block=local_bs)
            log(f"input sharding: {total} rows over {world} processes, {pad} steps/epoch, "
                f"{local_bs} rows/process/step")

        def train_stream(epoch, skip_batches=0):
            src = _stream(cfg, files, max_nnz, weights, shuffle_epoch=epoch, steps_per_call=k,
                          log=log, skip_batches=skip_batches,
                          convert=_wire_converter(cfg, model, max_nnz, device, weights),
                          batch_size=local_bs, shard=shard, pad_to_batches=pad,
                          wait_for_peer=wait)
            return _scaled(_to_batches(src, model, device), world)

        def ids_of(batch):
            return step_fn.last_batch().ids if k > 1 else batch.ids

    evaluate = None
    if world > 1:
        val_steps = (-(-count_lines(cfg.validation_files) // cfg.batch_size)
                     if cfg.validation_files else 0)

        def evaluate(st):
            # Every rank scores its rows; the scores come back global, and
            # the labels and weights are gathered beside them (weight-0
            # padding drops out of the AUC).
            meter = StreamingAUC()
            for parsed, w in _stream(cfg, cfg.validation_files, max_nnz, log=log,
                                     batch_size=local_bs, pad_to_batches=val_steps,
                                     shard=dict(shard_index=rank, shard_count=world,
                                                shard_block=local_bs), wait_for_peer=wait):
                b = Batch.from_parsed(parsed, w, device, with_fields=model.uses_fields)
                scores = predict_step(st, b)
                labels = all_gather_cat(b.labels, None, world)
                wts = all_gather_cat(b.weights, None, world)
                meter.add(labels.cpu().numpy(), scores.cpu().numpy(), wts.cpu().numpy())
            return meter.value()

    extra_metrics = None
    if cfg.lookup == "alltoall" and cfg.lookup_overflow == "fallback":
        drained = [0]

        def extra_metrics():
            n, drained[0] = step_fn.overflow_steps - drained[0], step_fn.overflow_steps
            return {"lookup_overflow_steps": n}

    touched_rows = None
    if world > 1:
        def touched_rows(st, bitmap):
            return gather_touched_rows(st, bitmap, model, mesh)

    run = dict(model=model, device=device, step_fn=step_fn, train_stream=train_stream,
               ids_of=ids_of, predict_step=predict_step, max_nnz=max_nnz, log=log,
               step_hook=step_hook, accum_restart=None, stream_stop=None, evaluate=evaluate,
               saveable=lambda st: gather_logical_state(st, model, mesh), runtime=runtime,
               chips=mesh.size, extra_metrics=extra_metrics, touched_rows=touched_rows)
    # on_nan = rollback: the loss every rank checks is all-reduced (the
    # same), so every rank raises at the same step with the same cursor; a
    # barrier and an agreement on the restored head come before training
    # goes on.
    rollbacks = 0
    rollback_note = None
    while True:
        try:
            state = _run_training(cfg, state, start_cursor=start_cursor, rollback=rollback_note,
                                  **run)
        except NonFiniteLossError as e:
            if (
                cfg.on_nan != "rollback"
                or rollbacks >= cfg.max_rollbacks
                or e.cursor is None
                or latest_step(cfg.model_file) is None
            ):
                raise
            rollbacks += 1
            runtime.barrier(f"rollback-{rollbacks}")
            _restore_into(state, restore_state())
            runtime.agree(f"rollback-head-{rollbacks}", {
                "step": int(state.step), "head": chain_head(),
                "cursor": [e.cursor.get("epoch"), e.cursor.get("batch_in_epoch")],
            })
            # A fresh KV namespace: the next attempt's save ordinals must not
            # meet the aborted attempt's keys.
            runtime.advance_namespace()
            start_cursor = dict(e.cursor, _exact=True)
            rollback_note = {
                "step": e.step,
                "loss": e.loss,
                "rollback_n": rollbacks,
                "restored_step": int(state.step),
                "skip_to_epoch": int(e.cursor.get("epoch", 0)),
                "skip_to_batch": int(e.cursor.get("batch_in_epoch", 0)),
            }
            log(
                f"on_nan = rollback: non-finite loss at step {e.step}; "
                f"restored {cfg.model_file} (step {int(state.step)}), "
                f"skipping input to epoch {rollback_note['skip_to_epoch']} "
                f"batch {rollback_note['skip_to_batch']} "
                f"(rollback {rollbacks}/{cfg.max_rollbacks})"
            )
        else:
            if runtime.heartbeat is not None:
                runtime.heartbeat.close()  # its last write: the run's last step
            return state
