"""The local training driver — the counterpart of ``fast_tffm_tpu/training.py``
``train`` + ``_run_training`` (single device, streamed text input).

  train(cfg, resume=False, log=print, device=None) -> TrainState

One epoch is a prefetched ``batch_stream`` over ``train_files`` (host
parsing overlaps the card's step), one train step per batch, a log line
every ``log_every`` steps (mean loss, examples/sec, in the JAX package's
wording), a non-finite loss check before any save, the validation AUC over
``validation_files`` and a save every ``save_every_epochs`` epochs; the
final state is saved and returned.  ``device`` None means the card.

Two table layouts train.  ``rows``: the sparse tail is the rows Adagrad
kernel's wrapper (``trainer.train_step_body``).  ``packed`` with
``adagrad_accumulator = fused``: the state is lane-packed
(``trainer.pack_state(fused=True)``) after the logical restore or init,
steps gather through ``fused_gather`` and end in the fused Adagrad kernel
(``trainer.packed_train_step_body``), validation scores through the fused
gather, and every save writes the logical arrays (``trainer.unpack_state``).
Either tail is its kernel on the card, whatever ``[Train] tail`` and
``packed_update`` say, and its plain twin on the CPU; a setting that names
a JAX compiler path the port has no counterpart of says so in the log on
the card.  The packed element/row tails, the telemetry monitor, the
async/delta checkpointer, rollback, signals, step fusion and the other
input paths are later slices; ``train`` refuses their config keys before
it touches a device.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
from fast_tffm_tpu_torch.config import Config, build_model, refuse_later_slices
from fast_tffm_tpu_torch.data.libsvm import scan_max_nnz
from fast_tffm_tpu_torch.data.pipeline import batch_stream
from fast_tffm_tpu_torch.device import resolve_device
from fast_tffm_tpu_torch.metrics import StreamingAUC, Throughput
from fast_tffm_tpu_torch.models.base import Batch
from fast_tffm_tpu_torch.trainer import (
    init_packed_state,
    init_state,
    make_packed_predict_step,
    make_packed_train_step,
    make_predict_step,
    make_train_step,
    pack_state,
    unpack_state,
)
from fast_tffm_tpu_torch.utils.prefetch import prefetch

__all__ = ["train", "NonFiniteLossError"]


class NonFiniteLossError(RuntimeError):
    """The training loss went non-finite; raised before any save."""

    def __init__(self, msg: str, *, step: int, loss: float):
        super().__init__(msg)
        self.step = step
        self.loss = loss


def _check_finite(loss: float, step: int) -> None:
    """Abort on a non-finite loss instead of training on (and eventually
    checkpointing) poisoned state (``on_nan = abort``)."""
    if not np.isfinite(loss):
        raise NonFiniteLossError(
            f"training loss is {loss}; likely a diverged model — lower "
            "learning_rate.  Aborting before the next checkpoint overwrites "
            "the last good state.",
            step=int(step),
            loss=float(loss),
        )


def _stream(cfg: Config, files, max_nnz: int, weights=None):
    """One prefetched pass over ``files``: (ParsedBatch, weights) pairs."""
    raw = batch_stream(
        files,
        batch_size=cfg.batch_size,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id=cfg.hash_feature_id,
        max_nnz=max_nnz,
        weights=weights,
    )
    return prefetch(raw, depth=cfg.queue_size)


def _evaluate(cfg: Config, predict_step, state, files, max_nnz: int, device) -> float:
    """AUC over ``files`` through the predict step, folded into a bounded
    streaming AUC (validation examples weigh 1.0; batch padding 0)."""
    meter = StreamingAUC()
    for parsed, w in _stream(cfg, files, max_nnz):
        scores = predict_step(state, Batch.from_parsed(parsed, w, device))
        meter.add(parsed.labels, scores.cpu().numpy(), w)
    return meter.value()


def _mean(losses) -> float:
    return float(torch.stack(losses).mean())


def _refuse_later_slices(cfg: Config) -> None:
    """The training settings whose paths are later slices of the port."""
    refuse_later_slices("train", [
        (cfg.table_layout == "packed" and cfg.adagrad_accumulator != "fused",
         f"table_layout = packed with adagrad_accumulator = {cfg.adagrad_accumulator} "
         "(the XLA packed tails)"),
        (cfg.shuffle, "shuffle = true (FMB memmap input)"),
        (cfg.binary_cache, "binary_cache = true (FMB input)"),
        (cfg.device_cache, "device_cache = true"),
        (cfg.steps_per_call > 1, "steps_per_call > 1 (step fusion)"),
        (cfg.dedup_gather_rows > 0, "dedup_gather_rows > 0 (dedup-before-gather)"),
        (cfg.paramstore, "[ParamStore] (the tiered parameter store)"),
        (cfg.online_follow, "[Online] follow (online learning)"),
        (cfg.online_accum_restart_steps > 0, "[Online] accum_restart_steps"),
        (cfg.on_nan == "rollback", "on_nan = rollback (resilience)"),
        (cfg.async_save, "[Checkpoint] async_save"),
        (cfg.delta_every_steps > 0, "[Checkpoint] delta_every_steps (delta saves)"),
        (bool(cfg.metrics_path), "metrics_path (telemetry)"),
        (bool(cfg.trace_dir), "trace_dir (profiling)"),
        (bool(cfg.telemetry_profile_steps), "[Telemetry] profile_steps (profiling)"),
    ])


def train(cfg: Config, *, resume: bool = False, log=print, device=None):
    """Local (single-device) training — the reference's ``train`` mode.

    ``resume`` restores ``cfg.model_file`` (table, accumulators, step);
    otherwise the state is a fresh init from a seeded generator.  Returns
    the final state in the layout it trained in (a fused state for
    ``table_layout = packed``); its logical arrays are saved to
    ``cfg.model_file``."""
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
    fused = cfg.table_layout == "packed"  # and so adagrad_accumulator = fused
    if resume:
        # The logical arrays first, packed after (never a fresh packed state
        # beside them).
        accum_width = model.row_dim if cfg.adagrad_accumulator == "element" else 1
        state = restore_checkpoint(cfg.model_file, device, accum_width=accum_width)
        if state.table.shape != (model.vocabulary_size, model.row_dim):
            raise ValueError(
                f"checkpoint {cfg.model_file!r} holds a {tuple(state.table.shape)} table; "
                f"this config trains [{model.vocabulary_size}, {model.row_dim}]"
            )
        if fused:
            state = pack_state(state, cfg.init_accumulator_value, fused=True)
        log(f"resumed from {cfg.model_file} at step {state.step}" + (" (packed)" if fused else ""))
        # No input cursor in this slice's checkpoints: the input restarts at
        # the first file, as the JAX package does for a cursorless one.
        log(
            "note: checkpoint carries no input cursor (pre-resilience "
            "format) — input restarts at the first file (legacy resume)"
        )
    else:
        generator = torch.Generator(device=device).manual_seed(0)
        if fused:
            state = init_packed_state(model, generator, cfg.init_accumulator_value)
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
    if fused:
        log("sparse tail: fused_tail_adagrad (fused one-pass gather→Adagrad→scatter)")
        step_fn = make_packed_train_step(model, cfg.learning_rate, cfg.packed_compact_cap)
        predict_step = make_packed_predict_step(model, fused=True)
    else:
        step_fn = make_train_step(model, cfg.learning_rate, decay=cfg.online_adagrad_decay)
        predict_step = make_predict_step(model)
    weights = cfg.weight_files or None

    meter = Throughput()
    losses: list[torch.Tensor] = []  # device values; only synced at log points
    start_step = state.step
    for epoch in range(cfg.epoch_num):
        for parsed, w in _stream(cfg, cfg.train_files, max_nnz, weights):
            first_call = state.step == start_step
            state, loss = step_fn(state, Batch.from_parsed(parsed, w, device))
            if first_call:
                # Call 1 pays the kernel builds and the allocator's warm-up;
                # a meter window that includes it reads as a collapse.
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                meter.reset()
            losses.append(loss)
            meter.add(parsed.batch_size)
            if len(losses) >= cfg.log_every:
                rate = meter.rate()
                mean_loss = _mean(losses)
                _check_finite(mean_loss, state.step)
                log(
                    f"step {state.step} epoch {epoch} "
                    f"loss {mean_loss:.5f} "
                    f"examples/sec {rate:,.0f} (/chip {rate:,.0f})"
                )
                losses.clear()
                meter.reset()
        if losses:
            # A poisoned state must abort BEFORE the save below replaces
            # the last good checkpoint.
            _check_finite(_mean(losses), state.step)
        if cfg.validation_files:
            val_auc = _evaluate(cfg, predict_step, state, cfg.validation_files, max_nnz, device)
            log(f"epoch {epoch} validation auc {val_auc:.5f}")
        if cfg.save_every_epochs and (epoch + 1) % cfg.save_every_epochs == 0:
            save_checkpoint(cfg.model_file, unpack_state(state, model))
            log(f"epoch {epoch} checkpoint -> {cfg.model_file}")
    save_checkpoint(cfg.model_file, unpack_state(state, model))
    log(f"training done: steps {start_step}->{state.step}, model -> {cfg.model_file}")
    return state

