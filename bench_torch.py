#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: train-step throughput, synced on
the final table, roofline-annotated — the counterpart of ``bench.py``.

    python bench_torch.py [--device cpu]             # the JSON line
    python bench_torch.py --dist [N] [OUT.json] [--device cpu]

It runs ``fast_tffm_tpu_torch`` on the card (``--device cpu`` runs the
plain versions on the CPU; without a card and without it, it raises) and
prints ONE JSON line with ``bench.py``'s keys for what it measures:

  value               the headline: FM order 2, k 8, nnz 39, a lane-packed
                      2^24-row table with an element accumulator updated in
                      kernel B4 at the packed address, Zipf(1.1) ids, batch
                      65,536 (demoted to batch 16,384, then to the scale
                      rung, the metric string saying which)
  scale_value         the LARGEST fused table the card holds (probed
                      largest-first from 1.5·2^30 rows, in process,
                      descending only on an out-of-memory error), kernel B3,
                      Zipf ids, batch 65,536; scale_b16384_value at 16,384
  tail_ab             the port's one sparse tail (kernel B3) with its
                      modeled bytes and the implied bandwidth
  zipf_interleaved_value / uniform_ids_value
                      the same step, Zipf against uniform ids, timed in one
                      interleaved window set
  fmb_streamed_value, wire_format_ab_allones
                      FMB file → memmap stream → the packed wire or arrays
                      → step (data/binary.py, data/wire.py)
  sharded_value       parallel/train_step.py's step at world size 1
  device_cached_*, steps_per_call_*
                      the resident epoch (data/device_cache.py), K = 1 and
                      K-step CUDA-graph replays (BENCH_STEPS_PER_CALL; on
                      at most SPC_MAX_VOCAB rows, steps_per_call_vocab_rows)
  packed_*            the headline's layout at batch 16,384 and 65,536
  ckpt_*              AsyncCheckpointer's sync, async and delta boundaries
  toy_vocab1m_value   the 1M-row uniform-id microbench

Every rate is the marginal time of ``iters`` steps between two syncs, best
of ``windows``; a window closes with ``torch.cuda.synchronize()`` and a
read of two rows of the final table (``forced_sync``).  The line also
carries the card (``nvidia-smi`` name and power limit), the torch and CUDA
versions and the kernel wrappers' launch counts over the run.  A section
that fails records ``*_error`` on the line and the script exits 1 after
printing it.  ``BENCH_RUNG`` pins the rung, ``BENCH_TAIL_MODES`` names the
tail (``cuda``; ``xla`` is refused: the port has no XLA tail),
``BENCH_CKPT_MODES`` the checkpoint boundaries.  After the line it writes
the round's delta report against the newest committed
``BENCH_TORCH_r*.json`` (tools/report.py).

``--dist N`` runs N ranks of ``training.dist_train`` (gloo on the CPU,
NCCL on the card, at most one rank per card) over shard-disjoint FMB files
and prints the pod's rate; ``--tier`` is not ported (ROADMAP §A item 11).
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fast_tffm_tpu_torch.models import Batch, FMModel  # noqa: E402
from fast_tffm_tpu_torch.serving.replica import launch_counts  # noqa: E402
from fast_tffm_tpu_torch.trainer import (  # noqa: E402
    TrainState,
    init_packed_state,
    init_state,
    make_packed_train_step,
    make_train_step,
)

BASELINE_EXAMPLES_PER_SEC_PER_CHIP = 500_000.0

# Largest-first ladder of table sizes for the card.  The fused layout takes
# 128·4 / floor(128 / 10) = 42.7 B a row at D = 9: 1.5·2^30 rows is 68.7 GB,
# 2^30 45.8 GB, 2^28 11.5 GB; 2^31 − 1 (91.6 GB) cannot fit in 80 GB.
SCALE_VOCABS = (1_610_612_736, 1 << 30, 1 << 29, 1 << 28, 1 << 24, 1 << 20)
SCALE_K = 8
NNZ = 39  # Criteo field count
BATCH = 16384
SCALE_CAP = 1 << 20
SCALE_BATCH_BIG = 65536
HEADLINE_VOCAB = 1 << 24
CKPT_VOCAB = 1 << 20
TOY_VOCAB = 1 << 20
FMB_ROWS = 1 << 19  # ensure_scale_fmb's default rows
STATE_CHUNK_ROWS = 1 << 22  # rows of a state built per generator call
# The largest rows state a K-step CUDA graph is captured on (its warm-up runs
# on a scratch copy of the whole state: twice the state must fit the card).
SPC_MAX_VOCAB = 1 << 28

NOMINAL_HBM_GBPS = {
    # Nominal HBM bandwidth by torch.cuda.get_device_name(), GB/s (NVIDIA's
    # data sheet; chip_smoke.py's HBM_BYTES_PER_S).
    "NVIDIA H100 80GB HBM3": 3350.0,
}

def zipf_ids(rng, shape, vocab):
    """Zipf(1.1) ids folded onto [0, vocab): a hot head (the same few ids
    recur across every batch) plus a tail spread uniformly over the whole
    table by the modulo — worst case for row-reuse in the gather and for
    locality in the update scatter."""
    z = rng.zipf(1.1, size=shape)
    return ((z - 1) % vocab).astype(np.int32)


def batch_arrays(ids, idx=0) -> dict:
    """``make_batch``'s host arrays (bench.py's, bit for bit).  Seeded by
    an explicit per-batch index, NOT ids[0,0]: Zipf's hot head collides on
    small values, giving several batches identical labels/vals."""
    rng = np.random.default_rng((idx, 0xB37C4))
    b, n = ids.shape
    return {
        "labels": rng.integers(0, 2, size=(b,)).astype(np.float32),
        "ids": np.asarray(ids, np.int32),
        "vals": np.abs(rng.normal(size=(b, n)).astype(np.float32)) + 0.1,
        "fields": np.zeros((b, n), np.int32),
        "weights": np.ones((b,), np.float32),
    }


def make_batch(ids, idx=0, device="cpu") -> Batch:
    return Batch(**{k: torch.from_numpy(v).to(device) for k, v in batch_arrays(ids, idx).items()})


def modeled_step_bytes(ids_batches, d_cols, accum_cols):
    """LOWER-BOUND HBM bytes/step for the order-2 sparse train step, from
    the actual batches (bench.py's formula): ids read, touched-row gather,
    rows re-read in the backward, per-occurrence row-grad write,
    segment-sum write, unique-row table/accumulator read-modify-write."""
    m = ids_batches[0].shape[0] * ids_batches[0].shape[1]
    uniq = float(np.mean([np.unique(np.asarray(b)).size for b in ids_batches]))
    row = d_cols * 4
    parts = {
        "ids_read": m * 4,
        "rows_gather_read": m * row,
        "rows_reread_bwd": m * row,
        "row_grads_write": m * row,
        "segsum_write": m * row,
        "table_update_rw": int(2 * uniq * row),
        "accum_rw": int(2 * uniq * accum_cols * 4),
    }
    return parts, int(sum(parts.values())), uniq


def modeled_fused_step_bytes(ids_batches, d, vocab, cap, batch_scale=1):
    """LOWER-BOUND HBM bytes/step of the JAX package's fused-layout compact
    step (bench.py's formula, kept for the comparison): wide gather,
    [M, 128] grad rows, G scatter-add, bitmap + prefix sum, capped RMW.
    ``batch_scale`` scales the M-proportional parts; the scaled uniques
    then overstate the floor slightly (unions of batches overlap)."""
    p = 128 // (d + 1)
    vpf = -(-vocab // p)
    m = ids_batches[0].shape[0] * ids_batches[0].shape[1] * batch_scale
    uniq = float(np.mean([np.unique(np.asarray(b)).size for b in ids_batches]))
    uniq_phys = float(
        np.mean([np.unique(np.asarray(b) // p).size for b in ids_batches])
    ) * batch_scale
    k_rows = min(cap if cap > 0 else m, min(vpf, m), int(uniq_phys) or m)
    row_b = 128 * 4
    parts = {
        "ids_read": m * 4,
        "fwd_gather_read": m * row_b,
        "grad_rows_write": m * row_b,
        "gbuild_scatter_rw": m * row_b + k_rows * row_b,
        "bitmap_cumsum_rw": vpf * (1 + 1 + 4 + 4),
        "rmw_gather_read": k_rows * row_b,
        "rmw_scatter_write": k_rows * row_b,
    }
    return parts, int(sum(parts.values())), uniq


def modeled_pallas_tail_step_bytes(ids_batches, d, vocab, cap, batch_scale=1):
    """LOWER-BOUND HBM bytes/step of the fused layout under a one-pass
    tail (bench.py's formula; the port's kernel B3 is such a tail): ids
    read, wide tile-row gather, [M, D] grads and their segment sum, then
    each touched row's D+1-lane slot read once and written once."""
    m = ids_batches[0].shape[0] * ids_batches[0].shape[1] * batch_scale
    uniq = (
        float(np.mean([np.unique(np.asarray(b)).size for b in ids_batches]))
        * batch_scale
    )
    k_rows = min(cap if cap > 0 else m, m, int(uniq) or m)
    row_b = 128 * 4
    slot_b = (d + 1) * 4
    parts = {
        "ids_read": m * 4,
        "fwd_gather_read": m * row_b,
        "grad_rows_write": m * d * 4,
        "segsum_write": m * d * 4,
        "tail_gather_read": int(k_rows * slot_b),
        "tail_scatter_write": int(k_rows * slot_b),
    }
    return parts, int(sum(parts.values())), uniq


def modeled_packed_tail_step_bytes(ids_batches, d, batch_scale=1):
    """LOWER-BOUND HBM bytes/step of the packed headline as the port runs
    it: ids read, the D-float row of every occurrence gathered, its
    gradient written, then kernel B4 reading the [M, D] gradients and each
    unique row's D table and D accumulator floats once and writing them
    once.  The uniques come from the actual batches (scaled as above)."""
    m = ids_batches[0].shape[0] * ids_batches[0].shape[1] * batch_scale
    uniq = (
        float(np.mean([np.unique(np.asarray(b)).size for b in ids_batches]))
        * batch_scale
    )
    row = d * 4
    parts = {
        "ids_read": m * 4,
        "rows_gather_read": m * row,
        "row_grads_write": m * row,
        "tail_grads_read": m * row,
        "tail_table_rw": int(2 * uniq * row),
        "tail_accum_rw": int(2 * uniq * row),
    }
    return parts, int(sum(parts.values())), uniq


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def scale_state(vocab, k, device) -> TrainState:
    """A rows-layout state: a [V, 1+k] table (uniform ±0.01, bias column
    zero) and a [V, 1] row accumulator at 0.1, built on the device in
    chunks from an explicit generator (bench.py's ``scale_state``)."""
    d = 1 + k
    g = _generator(device, 0)
    table = torch.empty((vocab, d), dtype=torch.float32, device=device)
    for lo in range(0, vocab, STATE_CHUNK_ROWS):
        part = table[lo : lo + STATE_CHUNK_ROWS]
        part.uniform_(-0.01, 0.01, generator=g)
        part[:, 0] = 0.0
    accum = torch.full((vocab, 1), 0.1, dtype=torch.float32, device=device)
    return TrainState(table=table, dense=[], step=0, table_accum=accum)


def fused_scale_state(vocab, k, device) -> TrainState:
    """A state in the FUSED tile-row layout ([VPf, 128]: D row lanes + 1
    row-accumulator lane per slot), built on the device in chunks from an
    explicit generator with ``bench.py::fused_scale_state``'s values:
    uniform ±0.01 in the row lanes, 0.1 in the accumulator and pad lanes."""
    from fast_tffm_tpu_torch.ops.packed_table import LANES, fused_packed_rows

    d = 1 + k
    vpf = fused_packed_rows(vocab, d)
    p = LANES // (d + 1)
    lanes = torch.arange(LANES, device=device)
    fill = ((lanes < p * (d + 1)) & (lanes % (d + 1) == d)) | (lanes >= p * (d + 1))
    g = _generator(device, 0)
    table = torch.empty((vpf, LANES), dtype=torch.float32, device=device)
    chunk = max(1, STATE_CHUNK_ROWS // p)
    for lo in range(0, vpf, chunk):
        part = table[lo : lo + chunk]
        part.uniform_(-0.01, 0.01, generator=g)
        part.masked_fill_(fill, 0.1)
    return TrainState(table=table, dense=[], step=0, layout="fused")


def forced_sync(state) -> float:
    """Close a timing window on the final state: ``torch.cuda.synchronize()``
    and then a read of two rows of the table, which cannot complete before
    every queued update to it has (the counterpart of bench.py's
    value-dependent sync)."""
    table = state.table
    if table.device.type == "cuda":
        torch.cuda.synchronize(table.device)
    return float(table[:2].sum())


def measure(step, state, batches, iters, windows=3, batch_size=None):
    """(final state, best-window examples/sec): the marginal time of
    ``iters`` steps between two forced syncs, best of ``windows``, after
    the first call and a 3-step warm-up outside the windows.
    ``batch_size`` defaults to the module BATCH (batches may be index
    handles of the device cache, which carry no size)."""
    bsz = BATCH if batch_size is None else batch_size
    state, loss = step(state, batches[0])
    forced_sync(state)
    for i in range(1, 4):
        state, loss = step(state, batches[i % len(batches)])
    forced_sync(state)
    best_dt = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            state, loss = step(state, batches[i % len(batches)])
        forced_sync(state)
        best_dt = min(best_dt, time.perf_counter() - t0)
    return state, bsz * iters / best_dt


def interleaved_measure(step, state, batches_a, batches_b, iters, rounds=4, batch=None):
    """((rate_a, rate_b), final state): the A and B batch sets timed in
    alternating windows (A B A B ...), each closed by forced_sync, medians
    per side — an A-vs-B claim comes from one interleaved window set."""
    b = batch or BATCH
    state, _ = step(state, batches_a[0])
    forced_sync(state)
    state, _ = step(state, batches_b[0])
    forced_sync(state)
    ta, tb = [], []
    for _ in range(rounds):
        for batches, acc in ((batches_a, ta), (batches_b, tb)):
            t0 = time.perf_counter()
            for i in range(iters):
                state, _ = step(state, batches[i % len(batches)])
            forced_sync(state)
            acc.append(time.perf_counter() - t0)
    return (b * iters / statistics.median(ta), b * iters / statistics.median(tb)), state


def fmb_cache_path(vocab, rows, seed, all_ones) -> str:
    """bench.py's cache naming under the temporary directory (``/tmp``
    unless TMPDIR says otherwise), so either package reads the other's."""
    tag = "ones" if all_ones else "zipf"
    return os.path.join(tempfile.gettempdir(), "fmb_scale_cache",
                        f"{tag}_v{vocab}_n{NNZ}_r{rows}_s{seed}.fmb")


def ensure_scale_fmb(vocab, rows=None, seed=7, all_ones=False):
    """Synthesize (once, cached) an FMB file of Zipf-id rows at the scale
    vocab, in the FMB layout directly, byte for byte bench.py's file.
    ``all_ones`` writes 1.0 values with the v2 elision flags set."""
    from fast_tffm_tpu_torch.data.binary import (
        _HEADER,
        FLAG_FIELDS_ALL_ZERO,
        FLAG_VALS_ALL_ONES,
        FMB_MAGIC,
        FMB_VERSION,
        _section_offsets,
        open_fmb,
    )

    rows = FMB_ROWS if rows is None else rows
    path = fmb_cache_path(vocab, rows, seed, all_ones)
    if os.path.exists(path):
        try:
            f = open_fmb(path)
            if f.n_rows == rows and f.vocabulary_size == vocab and (
                not all_ones or f.header.flags & FLAG_VALS_ALL_ONES
            ):
                return path
        except ValueError:
            pass
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    o_lab, o_nnz, o_ids, o_val, o_fld, total = _section_offsets(rows, NNZ, 4)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.truncate(total)
    mm = np.memmap(tmp, np.uint8, mode="r+")
    flags = FLAG_FIELDS_ALL_ZERO | (FLAG_VALS_ALL_ONES if all_ones else 0)
    mm[: _HEADER.size] = np.frombuffer(
        _HEADER.pack(FMB_MAGIC, FMB_VERSION, rows, NNZ, vocab, 1, 4, flags, 0, 0, NNZ),
        np.uint8,
    )

    def view(off, count, dtype, shape):
        return mm[off : off + count * np.dtype(dtype).itemsize].view(dtype).reshape(shape)

    view(o_lab, rows, np.float32, (rows,))[:] = rng.integers(0, 2, size=rows).astype(np.float32)
    view(o_nnz, rows, np.int32, (rows,))[:] = NNZ
    view(o_ids, rows * NNZ, np.int32, (rows, NNZ))[:] = zipf_ids(rng, (rows, NNZ), vocab)
    if all_ones:
        view(o_val, rows * NNZ, np.float32, (rows, NNZ))[:] = 1.0
    else:
        view(o_val, rows * NNZ, np.float32, (rows, NNZ))[:] = np.abs(
            rng.normal(size=(rows, NNZ)).astype(np.float32)
        ) + 0.1
    view(o_fld, rows * NNZ, np.int32, (rows, NNZ))[:] = 0
    mm.flush()
    del mm
    os.replace(tmp, path)
    return path


def bench_fmb_streamed(step, state, path, vocab, device, wire_format="packed"):
    """(final state, examples/sec, info) through the real input path:
    memmap stream → a prefetch thread converting each batch (the packed
    wire's pinned buffer, one H2D and the unpack on a side stream; or
    ``arrays``: the host arrays copied) → the step.  ``info``: the wire
    bytes per step and the per-batch conversion median (ms)."""
    from fast_tffm_tpu_torch.data.binary import fmb_batch_stream, fmb_wire_flags, open_fmb
    from fast_tffm_tpu_torch.data.wire import WireConverter, arrays_nbytes, make_spec
    from fast_tffm_tpu_torch.utils.prefetch import prefetch

    count = open_fmb(path).n_rows // BATCH
    if wire_format == "packed":
        all_ones, _ = fmb_wire_flags([path])
        conv = WireConverter(make_spec(vocab, NNZ, with_vals=not all_ones, with_fields=False),
                             device)
        wire_bytes = conv.spec.batch_nbytes(BATCH)
    else:
        conv = lambda p, w: Batch.from_parsed(p, w, device, with_fields=False)  # noqa: E731
        wire_bytes = arrays_nbytes(BATCH, NNZ, with_fields=False)
    stage_ms = []

    def stream(timed=False):
        raw = fmb_batch_stream(
            [path], batch_size=BATCH, vocabulary_size=vocab,
            hash_feature_id=True, max_nnz=NNZ, epochs=1, drop_remainder=True,
        )

        def gen():
            for p, w in raw:
                t0 = time.perf_counter()
                b = conv(p, w)
                if timed:
                    stage_ms.append(1e3 * (time.perf_counter() - t0))
                yield b

        return prefetch(gen(), depth=8)

    def ready(b):
        return b.ready() if hasattr(b, "ready") else b

    for b in stream():  # warm epoch (page cache, kernels built)
        state, _ = step(state, ready(b))
    forced_sync(state)
    t0 = time.perf_counter()
    for b in stream(timed=True):
        state, _ = step(state, ready(b))
    forced_sync(state)
    dt = time.perf_counter() - t0
    info = {
        "wire_format": wire_format,
        "wire_bytes_per_step": wire_bytes,
        "h2d_stage_ms_median": round(statistics.median(stage_ms), 3) if stage_ms else None,
    }
    return state, count * BATCH / dt, info


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_scale_rung(ladder, device, rng, results):
    """The scale rung, largest-first over ``ladder``: a fused state, 16
    Zipf batches at BATCH measured (20 steps a window), then 6 at
    SCALE_BATCH_BIG (10).  A rung that raises an out-of-memory error is
    recorded in ``scale_fallbacks`` and freed, and the next one tried; any
    other error propagates.  Returns (vocab, model, step, state, batches,
    rates) of the first rung that runs both batches, or None."""
    for cand in ladder:
        stepped_small = False
        try:
            model = FMModel(vocabulary_size=cand, factor_num=SCALE_K, order=2)
            step = make_packed_train_step(model, 0.01, compact_cap=SCALE_CAP)
            batches = [make_batch(zipf_ids(rng, (BATCH, NNZ), cand), i, device)
                       for i in range(16)]
            state = fused_scale_state(cand, SCALE_K, device)
            state, small_rate = measure(step, state, batches, iters=20)
            stepped_small = True
            big = [make_batch(zipf_ids(rng, (SCALE_BATCH_BIG, NNZ), cand), 50 + i, device)
                   for i in range(6)]
            state, big_rate = measure(step, state, big, iters=10, batch_size=SCALE_BATCH_BIG)
            del big
            return cand, model, step, state, batches, (small_rate, big_rate)
        except torch.cuda.OutOfMemoryError as e:
            msg = str(e).splitlines()[0][:100] if str(e) else "out of memory"
            at = SCALE_BATCH_BIG if stepped_small else BATCH
            results.setdefault("scale_fallbacks", []).append(
                f"vocab={cand}: out of memory at B={at}: {msg}"
            )
            if stepped_small and "scale_max_rows" not in results:
                results["scale_max_rows"] = cand
                results["scale_max_rows_note"] = (
                    f"largest rung that allocates AND steps at B={BATCH} (fused layout); "
                    f"B={SCALE_BATCH_BIG} ran out of memory there"
                )
        state = batches = big = step = model = None  # noqa: F841
        _free(device)
    return None


def bench_main(device) -> tuple[dict, int]:
    """The bench's legs in bench.py's order; returns (result line, exit code)."""
    from fast_tffm_tpu_torch.telemetry import artifact_stamp, device_stamp, new_run_id

    rng = np.random.default_rng(0)
    results: dict = {}
    run_id = new_run_id()
    pinned = os.environ.get("BENCH_RUNG")
    ladder = (int(pinned),) if pinned else SCALE_VOCABS
    stamp = device_stamp(device)
    kind = stamp["device_name"]

    rung = run_scale_rung(ladder, device, rng, results)
    if rung is None:
        line = {
            "metric": "train examples/sec/chip (DEGRADED: no rung fits the device)",
            "value": None, "unit": "examples/sec/chip", "vs_baseline": None,
            **artifact_stamp(run_id), **stamp, **results,
        }
        return line, 1
    vocab, model, step, state, batches, (scale_rate, big_rate) = rung
    del rung  # the sections below free the rung's state by name
    results.setdefault("scale_fallbacks", [])
    results["scale_b16384_value"] = round(scale_rate, 1)
    results["scale_vocab_rows"] = vocab
    results.setdefault("scale_max_rows", vocab)
    results["scale_table_gib"] = round(vocab * (1 + SCALE_K) * 4 / 2**30, 2)
    results["scale_state_gib"] = round(state.table.numel() * 4 / 2**30, 2)
    results["scale_layout"] = "fused tile-row, kernel B3 (csrc/fused_tail_adagrad.cu)"
    results["scale_value"] = round(big_rate, 1)
    results["scale_batch"] = SCALE_BATCH_BIG
    if device.type == "cuda":
        results["scale_peak_device_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 2)

    # --- the roofline of the scale rung ---
    step_us = SCALE_BATCH_BIG / big_rate * 1e6
    # The port's step is a one-pass tail (kernel B3), so its floor is the
    # one-pass model; bench.py fed the XLA fused program's model here.
    parts, total_bytes, uniq = modeled_pallas_tail_step_bytes(
        [b.ids.cpu().numpy() for b in batches], 1 + SCALE_K, vocab, SCALE_CAP,
        batch_scale=SCALE_BATCH_BIG // BATCH,
    )
    nominal = NOMINAL_HBM_GBPS.get(kind)
    implied = total_bytes / (step_us * 1e-6) / 1e9
    results["scale_step_time_us"] = round(step_us, 2)
    results["scale_modeled_hbm_bytes_per_step"] = total_bytes
    results["scale_modeled_hbm_bytes_parts"] = parts
    results["scale_bytes_model"] = "modeled_pallas_tail_step_bytes (one-pass tail)"
    results["mean_unique_ids_per_batch"] = round(uniq / (SCALE_BATCH_BIG // BATCH), 1)
    results["scale_implied_hbm_gbps_floor"] = round(implied, 1)
    results["device_kind"] = kind
    results["nominal_hbm_gbps"] = nominal
    if nominal:
        results["scale_implied_over_nominal"] = round(implied / nominal, 2)
    else:
        results["scale_implied_over_nominal"] = None
        results["nominal_hbm_note"] = (
            f"no nominal HBM bandwidth known for {kind!r}: roofline keys are null"
        )

    # --- the sparse tail: the port has one, kernel B3 ---
    modes = [m.strip() for m in os.environ.get("BENCH_TAIL_MODES", "cuda").split(",")
             if m.strip()]
    refused = [m for m in modes if m != "cuda"]
    if refused:
        raise ValueError(
            f"BENCH_TAIL_MODES names {refused}: the port has one sparse tail, the Hopper "
            "kernel (cuda); the JAX package's XLA and Pallas tails do not exist here"
        )
    ids_16k = [b.ids.cpu().numpy() for b in batches]
    pp_parts, pp_total, _ = modeled_pallas_tail_step_bytes(ids_16k, 1 + SCALE_K, vocab,
                                                           SCALE_CAP)
    results["tail_ab"] = {"batch": BATCH, "modes": {"cuda": {
        "kernel": "fused_tail_adagrad (csrc/fused_tail_adagrad.cu)",
        "value": results["scale_b16384_value"],
        "b65536_value": results["scale_value"],
        "modeled_bytes_per_example": round(pp_total / BATCH, 1),
        "modeled_parts": pp_parts,
        "measured_bytes_per_example": None,  # no compiler cost analysis here
        "implied_hbm_gbps": round(pp_total * scale_rate / BATCH / 1e9, 1),
    }}}

    # --- Zipf against uniform ids, one interleaved window set ---
    try:
        uni = [make_batch(rng.integers(0, vocab, size=(BATCH, NNZ)).astype(np.int32), 100 + i,
                          device) for i in range(16)]
        (z_rate, u_rate), state = interleaved_measure(step, state, batches, uni, iters=10)
        results["zipf_interleaved_value"] = round(z_rate, 1)
        results["uniform_ids_value"] = round(u_rate, 1)
        results["uniform_over_zipf"] = round(u_rate / z_rate, 3)
        del uni
    except Exception as e:
        results["uniform_ids_value"] = None
        results["uniform_ids_error"] = repr(e)[:160]

    # --- end to end through the FMB input path, then the wire A/B ---
    try:
        state, fmb_rate, fmb_info = bench_fmb_streamed(step, state, ensure_scale_fmb(vocab),
                                                       vocab, device)
        results["fmb_streamed_value"] = round(fmb_rate, 1)
        results["streamed_wire_bytes_per_step"] = fmb_info["wire_bytes_per_step"]
        results["streamed_h2d_ms_median"] = fmb_info["h2d_stage_ms_median"]
    except Exception as e:
        results["fmb_streamed_value"] = None
        results["fmb_streamed_error"] = repr(e)[:160]
    try:
        ones_path = ensure_scale_fmb(vocab, all_ones=True)
        ab = {}
        for wf in ("packed", "arrays"):
            state, r, info = bench_fmb_streamed(step, state, ones_path, vocab, device,
                                                wire_format=wf)
            ab[wf] = {"value": round(r, 1), "wire_bytes_per_step": info["wire_bytes_per_step"],
                      "h2d_stage_ms_median": info["h2d_stage_ms_median"]}
        ab["wire_cut_x"] = round(
            ab["arrays"]["wire_bytes_per_step"] / ab["packed"]["wire_bytes_per_step"], 3)
        results["wire_format_ab_allones"] = ab
    except Exception as e:
        results["wire_format_ab_error"] = repr(e)[:160]

    # --- the sharded step (dist_train's) at world size 1, rows layout ---
    state = step = None
    _free(device)
    try:
        from fast_tffm_tpu_torch.parallel import make_mesh, make_sharded_train_step

        mesh = make_mesh(1, 1)
        sh_step = make_sharded_train_step(model, 0.01, mesh, accumulator="row")
        sh_state = scale_state(vocab, SCALE_K, device)
        sh_state, sh_rate = measure(sh_step, sh_state, batches, iters=20)
        results["sharded_value"] = round(sh_rate, 1)
        del sh_state
    except Exception as e:
        results["sharded_value"] = None
        results["sharded_error"] = repr(e)[:160]
    sh_state = None
    del batches
    _free(device)

    # --- the resident epoch (device_cache), K = 1 and K-step graphs ---
    try:
        from fast_tffm_tpu_torch.data.device_cache import (
            epoch_index_chunks,
            load_device_dataset,
            make_cached_scan_train_step,
            make_cached_train_step,
        )

        data = load_device_dataset(
            [ensure_scale_fmb(vocab)], batch_size=BATCH, vocabulary_size=vocab,
            hash_feature_id=True, max_nnz=NNZ, with_fields=False, device=device,
        )
        cached_step, _ = make_cached_train_step(model, 0.01, data)
        idx = [torch.tensor(i, dtype=torch.int64, device=device) for i in range(data.batches)]
        dc_state = scale_state(vocab, SCALE_K, device)
        dc_state, dc_rate = measure(cached_step, dc_state, idx, iters=20)
        results["device_cached_value"] = round(dc_rate, 1)
        results["device_cached_mib"] = round(data.nbytes / 2**20, 1)
        try:
            ks = [k for k in (int(x) for x in
                              os.environ.get("BENCH_STEPS_PER_CALL", "8").split(",")
                              if x.strip()) if k > 1]
            spc = {"1": round(dc_rate, 1)}
            spc_model = model
            if vocab > SPC_MAX_VOCAB:
                # A K-step graph's capture warms up on a scratch copy of the
                # state, which a state over ~40% of the card cannot have: the
                # K = 1 and K-step rates are taken on SPC_MAX_VOCAB rows,
                # the same Zipf draws folded onto them (SPC_MAX_VOCAB
                # divides every larger rung, so the ids are ensure_scale_fmb's
                # at that vocabulary).
                dc_state = None
                _free(device)
                data.ids.remainder_(SPC_MAX_VOCAB)
                spc_model = FMModel(vocabulary_size=SPC_MAX_VOCAB, factor_num=SCALE_K, order=2)
                spc_step, _ = make_cached_train_step(spc_model, 0.01, data)
                dc_state = scale_state(SPC_MAX_VOCAB, SCALE_K, device)
                dc_state, k1_rate = measure(spc_step, dc_state, idx, iters=20)
                spc = {"1": round(k1_rate, 1)}
                spc_step = None
            results["steps_per_call_vocab_rows"] = spc_model.vocabulary_size
            stepk, _ = make_cached_scan_train_step(spc_model, 0.01, data)
            for kk in ks:
                chunks = [c for c in epoch_index_chunks(data.batches, kk, device=device)
                          if len(c) == kk]
                dc_state, k_rate = measure(stepk, dc_state, chunks, iters=max(4, 24 // kk),
                                           batch_size=BATCH * kk)
                spc[str(kk)] = round(k_rate, 1)
            results["steps_per_call_values"] = spc
            if "8" in spc:
                results["steps_per_call_k8_over_k1"] = round(spc["8"] / spc["1"], 3)
        except Exception as e:
            results["steps_per_call_error"] = repr(e)[:160]
        finally:
            stepk = chunks = None  # the graphs hold the dataset and the state
        del data, cached_step, idx, dc_state
    except Exception as e:
        results["device_cached_value"] = None
        results["device_cached_error"] = repr(e)[:160]
    data = cached_step = idx = dc_state = None
    _free(device)

    # --- the headline: the lane-packed table, element accumulator, B4 ---
    try:
        from fast_tffm_tpu_torch.ops.packed_table import packed_rows

        pv = min(vocab, HEADLINE_VOCAB)
        pmodel = FMModel(vocabulary_size=pv, factor_num=SCALE_K, order=2)
        pstep = make_packed_train_step(pmodel, 0.01)
        pstate = init_packed_state(pmodel, _generator(device, 0), 0.1, accumulator="element")
        results["packed_vocab_rows"] = pv
        results["packed_physical_rows"] = packed_rows(pv, 1 + SCALE_K)
        results["packed_update_mode"] = (
            "kernel B4 at the packed address (csrc/rows_tail_adagrad.cu), element accumulator")
        pbatches = [make_batch(zipf_ids(rng, (BATCH, NNZ), pv), 300 + i, device)
                    for i in range(8)]
        pstate, p_rate = measure(pstep, pstate, pbatches, iters=20)
        results["packed_value"] = round(p_rate, 1)
        del pbatches
        try:
            kb = SCALE_BATCH_BIG
            kids = [zipf_ids(rng, (kb, NNZ), pv) for _ in range(4)]
            kbatches = [make_batch(ids, 400 + i, device) for i, ids in enumerate(kids)]
            pstate, _ = pstep(pstate, kbatches[0])
            forced_sync(pstate)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for i in range(10):
                    pstate, _ = pstep(pstate, kbatches[i % len(kbatches)])
                forced_sync(pstate)
                best = min(best, time.perf_counter() - t0)
            pk_rate = kb * 10 / best
            results["packed_b65536_value"] = round(pk_rate, 1)
            results["headline_batch"] = kb
            parts, total, _ = modeled_packed_tail_step_bytes(kids, 1 + SCALE_K)
            results["packed_modeled_hbm_bytes_per_step"] = total
            results["packed_modeled_hbm_bytes_parts"] = parts
            results["packed_implied_hbm_gbps_floor"] = round(total / (kb / pk_rate) / 1e9, 1)
            del kbatches
        except Exception as e:
            results["packed_b65536_value"] = None
            results["packed_b65536_error"] = repr(e)[:160]
        del pstate
    except Exception as e:
        results["packed_value"] = None
        results["packed_error"] = repr(e)[:160]
    pstate = kbatches = None
    _free(device)

    # --- the checkpoint boundaries: the loop's stall per save ---
    try:
        results.update(bench_ckpt(device, rng))
    except Exception as e:
        results["ckpt_ab_error"] = repr(e)[:160]

    # --- the 1M-row uniform-id microbench ---
    try:
        toy_model = FMModel(vocabulary_size=TOY_VOCAB, factor_num=8, order=2)
        toy_step = make_train_step(toy_model, learning_rate=0.01)
        toy_batches = [make_batch(rng.integers(0, TOY_VOCAB, size=(BATCH, NNZ)).astype(np.int32),
                                  200 + i, device) for i in range(8)]
        toy_state = init_state(toy_model, _generator(device, 0))
        _, toy_rate = measure(toy_step, toy_state, toy_batches, iters=30)
        results["toy_vocab1m_value"] = round(toy_rate, 1)
    except Exception as e:
        results["toy_vocab1m_value"] = None
        results["toy_error"] = repr(e)[:160]

    # The headline ladder (bench.py's): the packed knee batch, then the
    # packed default batch, then the scale rung.
    if results.get("packed_b65536_value") is not None:
        value = results["packed_b65536_value"]
        metric = (
            f"train examples/sec/chip (2nd-order FM, k=8, nnz=39, "
            f"vocab={results['packed_vocab_rows']} rows, lane-packed table + element "
            f"accumulator in kernel B4, batch {SCALE_BATCH_BIG}, Zipf(1.1) ids; scale rung "
            f"vocab={vocab} fused (kernel B3) at batch {SCALE_BATCH_BIG} on the line as "
            "scale_value)"
        )
    elif results.get("packed_value") is not None:
        value = results["packed_value"]
        metric = (
            f"train examples/sec/chip (2nd-order FM, k=8, nnz=39, "
            f"vocab={results['packed_vocab_rows']} rows, lane-packed table + element "
            f"accumulator in kernel B4, batch {BATCH}, Zipf(1.1) ids)"
        )
    else:
        value = results["scale_value"]
        metric = (
            f"train examples/sec/chip (2nd-order FM, k=8, nnz=39, vocab={vocab} rows "
            f"~{results['scale_table_gib']}GiB table, Zipf(1.1) ids, fused tile-row layout, "
            "kernel B3)"
        )
    result = {
        "metric": metric,
        "value": value,
        "unit": "examples/sec/chip",
        "vs_baseline": round(value / BASELINE_EXAMPLES_PER_SEC_PER_CHIP, 4),
        **artifact_stamp(run_id),
        **stamp,
        "kernel_launches": launch_counts(),
        **results,
    }
    return result, 1 if section_errors(result) else 0


def section_errors(result: dict) -> list[str]:
    """The keys of the sections that failed (``*_error``, nested too)."""
    out = []
    for k, v in result.items():
        if k.endswith("_error"):
            out.append(k)
        elif isinstance(v, dict):
            out += [f"{k}.{e}" for e in section_errors(v)]
    return out


def bench_ckpt(device, rng) -> dict:
    """AsyncCheckpointer's three boundaries on a 2^20-row state (bench.py's
    ckpt leg): the loop's stall per save (median of 3) and bytes per save,
    ``BENCH_CKPT_MODES`` (default sync,async,delta) selecting them."""
    import shutil

    from fast_tffm_tpu_torch.checkpoint_async import AsyncCheckpointer

    modes = [m.strip() for m in os.environ.get("BENCH_CKPT_MODES", "sync,async,delta").split(",")
             if m.strip()]
    cv = CKPT_VOCAB
    cmodel = FMModel(vocabulary_size=cv, factor_num=SCALE_K, order=2)
    cstate = init_state(cmodel, _generator(device, 1))
    cbatch = make_batch(zipf_ids(rng, (BATCH, NNZ), cv), 900, device)
    cdir = tempfile.mkdtemp(prefix="bench_ckpt_")
    ident = lambda s: s  # noqa: E731
    stall_ms: dict = {}
    bytes_per: dict = {}
    quiet = lambda *_: None  # noqa: E731
    out: dict = {}
    try:
        if "sync" in modes:
            ck = AsyncCheckpointer(os.path.join(cdir, "sync.ckpt"), device=device, log=quiet)
            ts = []
            for i in range(3):
                t0 = time.perf_counter()
                ck.save_boundary(cstate, ident, i, sync=True, emit=False)
                ts.append((time.perf_counter() - t0) * 1e3)
            stall_ms["sync"] = round(statistics.median(ts), 2)
            bytes_per["full"] = os.path.getsize(os.path.join(cdir, "sync.ckpt"))
        if "async" in modes:
            ck = AsyncCheckpointer(os.path.join(cdir, "async.ckpt"), device=device, log=quiet,
                                   async_save=True)
            ts = []
            for i in range(3):
                t0 = time.perf_counter()
                ck.save_boundary(cstate, ident, i)
                ts.append((time.perf_counter() - t0) * 1e3)
                ck.finalize()  # the writer's time is excluded: it overlaps training
            stall_ms["async"] = round(statistics.median(ts), 2)
        if "delta" in modes:
            ck = AsyncCheckpointer(os.path.join(cdir, "delta.ckpt"), device=device, log=quiet,
                                   delta_every_steps=1, vocab=cv, row_dim=1 + SCALE_K)
            ck.save_boundary(cstate, ident, 0, sync=True, emit=False)  # the base
            ts = []
            for i in range(3):
                ck.note_batch(cbatch.ids)
                t0 = time.perf_counter()
                ck.delta_boundary(cstate, ident, i + 1)
                ts.append((time.perf_counter() - t0) * 1e3)
                ck.finalize()
            stall_ms["delta"] = round(statistics.median(ts), 2)
            dps = sorted(p for p in os.listdir(cdir) if ".delta-" in p and p.endswith(".npz"))
            if dps:
                bytes_per["delta"] = os.path.getsize(os.path.join(cdir, dps[-1]))
        out["ckpt_stall_ms_per_save"] = stall_ms
        out["ckpt_bytes_per_save"] = bytes_per
        if "sync" in stall_ms and "async" in stall_ms and stall_ms["sync"]:
            out["ckpt_async_over_sync_stall"] = round(stall_ms["async"] / stall_ms["sync"], 4)
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    return out


# --- --dist: the port's dist_train over N processes ------------------------

DIST_VOCAB, DIST_ROWS, DIST_BATCH = 1 << 16, 1 << 15, 2048

_DIST_WORKER = '''
import sys
pid, nproc, port, tmp, files, device = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5], sys.argv[6]
)
sys.path.insert(0, {repo!r})
from fast_tffm_tpu_torch.config import Config
from fast_tffm_tpu_torch.training import dist_train

cfg = Config(
    model="fm", factor_num=8, vocabulary_size={vocab},
    model_file=f"{{tmp}}/m.ckpt",
    train_files=tuple(files.split(",")),
    epoch_num=1, batch_size={batch}, max_nnz={nnz}, learning_rate=0.01,
    log_every=4, metrics_path=f"{{tmp}}/run.jsonl",
    telemetry_run_id={run_id!r},
    input_assignment="files",
    barrier_timeout_s=120,
    hash_feature_id=True,  # the synthetic FMB files are written hashed
    coordinator_address=f"127.0.0.1:{{port}}", num_processes=nproc, process_id=pid,
)
cfg.validate()
# None: rank r on its own card (cuda:<local index>); "cpu": a gloo rank.
dist_train(cfg, log=lambda m: print(f"[{{pid}}] {{m}}", flush=True),
           device=None if device == "cuda" else device)
print(f"[{{pid}}] BENCH DONE", flush=True)
'''


def bench_dist(processes: int, device, out_path: str | None = None, run_id: str = "") -> dict:
    """The processes lever: N OS processes of the port's ``dist_train``
    (gloo ranks on the CPU, NCCL ranks on the card, one card each), over
    shard-disjoint FMB files (``input_assignment = files``), the packed
    wire.  Reports the pod's rate (every rank trains the same global
    batch, so rank 0's meter is the pod's), per-rank medians and the
    steady-state compile count, as bench.py's ``--dist``."""
    import socket
    import subprocess

    from fast_tffm_tpu_torch.telemetry import artifact_stamp, device_stamp, write_json_artifact

    if device.type == "cuda" and processes > torch.cuda.device_count():
        raise ValueError(f"--dist {processes} on the card needs {processes} cards, "
                         f"found {torch.cuda.device_count()}")
    files = [ensure_scale_fmb(DIST_VOCAB, rows=DIST_ROWS, seed=7 + p) for p in range(processes)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stamp = artifact_stamp(run_id)
    run_id = stamp["run_id"]
    backend = "NCCL" if device.type == "cuda" else "gloo"
    result: dict = {
        "metric": (
            f"dist_train global examples/sec ({processes}-process {device.type} pod, "
            f"{backend}, shard-disjoint FMB files, packed wire, batch {DIST_BATCH}, "
            f"vocab {DIST_VOCAB}, nnz {NNZ})"
        ),
        **stamp,
        **device_stamp(device),
        "processes": processes,
        "rows_per_host": DIST_ROWS,
    }
    with tempfile.TemporaryDirectory(prefix="bench-dist-") as tmp:
        script = os.path.join(tmp, "worker.py")
        with open(script, "w") as f:
            f.write(_DIST_WORKER.format(repo=HERE, vocab=DIST_VOCAB, batch=DIST_BATCH, nnz=NNZ,
                                        run_id=run_id))
        procs = [
            subprocess.Popen(
                [sys.executable, script, str(p), str(processes), str(port), tmp,
                 ",".join(files), device.type],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for p in range(processes)
        ]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [out for proc, out in zip(procs, outs) if proc.returncode != 0]
        if failed:
            result["dist_error"] = failed[0][-800:]
            result["value"] = None
        else:
            per_host = {}
            for p in range(processes):
                path = os.path.join(tmp, "run.jsonl" if p == 0 else f"run.p{p}.jsonl")
                recs = []
                if os.path.exists(path):
                    with open(path) as fh:
                        recs = [json.loads(line) for line in fh if line.strip()]
                rates = [r["examples_per_sec"] for r in recs if r.get("kind") == "train"]
                steady = sum(r.get("compiles", 0) for r in recs
                             if r.get("kind") == "compile" and not r.get("warmup"))
                wire = [r["wire_bytes_per_step"] for r in recs if r.get("kind") == "input"
                        and isinstance(r.get("wire_bytes_per_step"), (int, float))]
                per_host[str(p)] = {
                    "examples_per_sec_median": round(float(np.median(rates)), 1) if rates else None,
                    "steady_recompiles": steady,
                    "wire_bytes_per_step": int(np.median(wire)) if wire else None,
                }
            result["value"] = per_host["0"]["examples_per_sec_median"]
            result["unit"] = "examples/sec (global)"
            result["per_host"] = per_host
            result["steady_recompiles_total"] = sum(h["steady_recompiles"]
                                                    for h in per_host.values())
    if out_path:
        write_json_artifact(out_path, result)
    print(json.dumps(result), flush=True)
    return result


def _device_arg(argv: list) -> tuple[torch.device, list]:
    """``--device D`` taken out of ``argv``; None means the card."""
    from fast_tffm_tpu_torch.device import resolve_device

    device = None
    rest = []
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("bench_torch.py: --device needs a value (cuda | cpu)")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return resolve_device(device), rest


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--tier"]:
        raise SystemExit(
            "bench_torch.py --tier: the beyond-HBM rung runs tools/probe_tier.py, a tool of the "
            "JAX package only; its port is the chaos/soak slice (ROADMAP §A item 11)"
        )
    device, args = _device_arg(argv)
    if args[:1] == ["--dist"]:
        n = int(args[1]) if len(args) > 1 else int(os.environ.get("BENCH_PROCESSES", "2"))
        out = args[2] if len(args) > 2 else None
        result = bench_dist(n, device, out)
        return 1 if section_errors(result) else 0
    if args:
        raise SystemExit(f"bench_torch.py: unknown arguments {args}")
    result, rc = bench_main(device)
    print(json.dumps(result), flush=True)
    if rc:
        print(f"bench_torch.py: failed sections: {section_errors(result) or ['scale rung']}",
              file=sys.stderr, flush=True)
    try:
        from tools.report import write_bench_report

        rp = write_bench_report(result, HERE, prefix="BENCH_TORCH_r")
        if rp:
            print(f"bench report -> {rp}", file=sys.stderr)
    except (OSError, ValueError, KeyError, TypeError) as e:
        print(f"bench report skipped: {e!r}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
