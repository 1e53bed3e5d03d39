#!/usr/bin/env python
"""Train-step throughput of the PyTorch/CUDA port for all five BASELINE
configs, and the packed rows — the counterpart of ``bench_all.py``.

    python bench_all_torch.py [--out FILE] [--full] [--device cpu]

It runs ``fast_tffm_tpu_torch`` on the card (``--device cpu`` runs the
plain versions on the CPU; without a card and without it, it raises),
prints one JSON line per metric with ``bench_all.py``'s keys, and rewrites
the artifact (``--out``, default ``BENCH_ALL_TORCH.json``) after every
metric:

  #1 2nd-order FM k=8   (Criteo-sample shape: 39 feats, 1M vocab)
  #2 2nd-order FM k=16  (Criteo-1TB shape: 16M vocab, parallel/'s step at
                         world size 1: one card)
  #3 FFM k=4            (Avazu shape: 22 fields)
  #4 DeepFM 3x400 MLP   (Criteo shape; bf16 MLP operands)
  #5 order-3 FM k=8     (KDD-2012 shape: 11 feats; kernels B1 and B2)

then predict, the host input path, text against FMB end to end
(interleaved), the convergence pair (the fit line; the held-out line beside
the planted model's oracle AUC; ``--full`` takes 2.4M held-out rows instead
of 600k), and the packed rows cfg1p, cfg3p, cfg3pb, cfg4p, cfg5p and cfg2p
(kernel B4 at the packed address, each with its knee batch).  As
``bench_all.py`` does with the JAX package's artifacts, it folds the port's
quality artifacts measured on the card: the cfg3/cfg4/cfg5 quality rows
from ``QUALITY_ZOO_TORCH_r17.json`` (``tools/torch_quality_zoo.py``), and
the held-out line's converged point from ``SCALING_STUDY_TORCH_r17.json``
(``tools/torch_scaling_study.py``, this run's slice beside it).
A section that fails records a ``(FAILED)`` row and the script exits 1 at
its end.  Batches are synthetic (``bench_all.py``'s draws, bit for bit);
the text files are ``bench_all.py``'s too (``tools/gen_synthetic.py``'s
bytes), written by one ``tools/torch_gen_synthetic.py`` process each before
the first timed section.
"""

from __future__ import annotations

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

from bench_torch import forced_sync  # noqa: E402
from fast_tffm_tpu_torch.models import Batch, DeepFMModel, FFMModel, FMModel  # noqa: E402
from fast_tffm_tpu_torch.serving.replica import launch_counts  # noqa: E402
from fast_tffm_tpu_torch.trainer import init_state, make_train_step  # noqa: E402

BASELINE = 500_000.0  # examples/sec/chip north star

# The sizes of the sections (bench_all.py's); the tests shrink them.
B = 16384
VOCAB = 1 << 20
VOCAB_CFG2 = 1 << 24
INPUT_ROWS = 200_000
E2E_ROWS = 400_000
FIT_ROWS, FIT_EPOCHS = 5_000, 40
HELDOUT_ROWS, HELDOUT_FULL_ROWS, HELDOUT_TEST_ROWS = 600_000, 2_400_000, 50_000
CONV_VOCAB = 1 << 14
# The port's quality artifacts from the card, folded into the sweep.
QUALITY_ZOO = os.path.join(HERE, "QUALITY_ZOO_TORCH_r17.json")
SCALING_STUDY = os.path.join(HERE, "SCALING_STUDY_TORCH_r17.json")


class Sweep:
    """The rows reported so far and the artifact they are written to after
    every one (a late failure or a kill keeps what ran)."""

    def __init__(self, path, tag: str, device):
        from fast_tffm_tpu_torch.telemetry import device_stamp

        self.path = path
        self.tag = tag
        self.device = device
        self.stamp = device_stamp(device)
        self.results: list[dict] = []

    def write(self) -> None:
        if self.path is None:
            return
        artifact = {
            "generated_by": "bench_all_torch.py" + self.tag,
            "chips": 1,
            **self.stamp,
            "baseline_examples_per_sec_per_chip": BASELINE,
            "note": (
                "single run per metric on one card; every rate is the best of 3 windows "
                "closed by torch.cuda.synchronize() and a read of the final table "
                "(bench_torch.forced_sync); end-to-end rows are host-bound"
            ),
            "kernel_launches": launch_counts(),
            "results": self.results,
        }
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(artifact, f, indent=1)
        os.replace(tmp, self.path)

    def report(self, name, value, unit="examples/sec/chip", **extra) -> None:
        rec = {
            "metric": name,
            "value": round(value, 5 if "AUC" in unit else 1),
            "unit": unit,
            "vs_baseline": extra.pop("vs_baseline", round(value / BASELINE, 4)),
            **extra,
        }
        self.results.append(rec)
        print(json.dumps(rec), flush=True)
        self.write()

    def guard(self, fn, *a, **kw) -> bool:
        """One section: a failure costs one ``(FAILED)`` row, not the sweep."""
        try:
            fn(self, *a, **kw)
            return True
        except Exception as e:
            name = a[0] if a and isinstance(a[0], str) else getattr(fn, "__name__", "?")
            rec = {"metric": f"{name} (FAILED)", "value": None, "unit": "",
                   "vs_baseline": None, "error": repr(e)[:200]}
            self.results.append(rec)
            print(json.dumps(rec), flush=True)
            self.write()
            return False

    def failed(self) -> list[str]:
        """The FAILED rows, and the rows whose knee run failed (its row keeps
        bench_all.py's ``knee_error`` key; the exit code says it failed)."""
        return [r["metric"] + (" (knee_error)" if "knee_error" in r else "")
                for r in self.results
                if r["metric"].endswith("(FAILED)") or "knee_error" in r]


def batch_arrays(rng, batch_size, nnz, vocab, num_fields=0) -> dict:
    """``bench_all.py::make_batch``'s host arrays, bit for bit."""
    fields = (
        np.tile(np.arange(nnz, dtype=np.int32) % max(num_fields, 1), (batch_size, 1))
        if num_fields
        else np.zeros((batch_size, nnz), np.int32)
    )
    return {
        "labels": rng.integers(0, 2, size=(batch_size,)).astype(np.float32),
        "ids": rng.integers(0, vocab, size=(batch_size, nnz)).astype(np.int32),
        "vals": np.abs(rng.normal(size=(batch_size, nnz)).astype(np.float32)) + 0.1,
        "fields": fields,
        "weights": np.ones((batch_size,), np.float32),
    }


def make_batch(rng, batch_size, nnz, vocab, num_fields=0, device="cpu") -> Batch:
    arrays = batch_arrays(rng, batch_size, nnz, vocab, num_fields)
    return Batch(**{k: torch.from_numpy(v).to(device) for k, v in arrays.items()})


def time_step(step, state, batches, warmup=5, iters=30, windows=3, sync=None):
    """Steps/sec: ``warmup`` steps, then the best of ``windows`` windows of
    ``iters`` steps, each closed by ``sync(state, last output)`` (default
    ``forced_sync`` on the final table)."""
    if sync is None:
        sync = lambda st, out: forced_sync(st)  # noqa: E731
    for i in range(warmup):
        state, loss = step(state, batches[i % len(batches)])
    sync(state, loss)
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(iters):
            state, loss = step(state, batches[i % len(batches)])
        sync(state, loss)
        best = min(best, time.perf_counter() - t0)
    return iters / best


def _gen(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _knee_extra(step, state_fn, rng, knee_batch, nnz, vocab, num_fields, device):
    """The same step at the knee batch from a fresh state; extra row keys."""
    try:
        kb = [make_batch(rng, knee_batch, nnz, vocab, num_fields, device) for _ in range(4)]
        sps = time_step(step, state_fn(), kb, warmup=2, iters=10)
        return {"knee_batch": knee_batch, "knee_value": round(knee_batch * sps, 1)}
    except Exception as e:
        return {"knee_batch": knee_batch, "knee_error": repr(e)[:160]}


def bench_local(sw, name, model, batch_size, nnz, vocab, num_fields=0, lr=0.01,
                layout="rows", knee_batch=None):
    """The single-device step; ``layout = packed``: the lane-packed table
    with an element accumulator (kernel B4 at the packed address)."""
    from fast_tffm_tpu_torch.trainer import init_packed_state, make_packed_train_step

    dev = sw.device
    if layout == "packed":
        state_fn = lambda: init_packed_state(model, _gen(dev), 0.1, accumulator="element")  # noqa: E731
        step = make_packed_train_step(model, lr)
    else:
        state_fn = lambda: init_state(model, _gen(dev))  # noqa: E731
        step = make_train_step(model, lr)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, batch_size, nnz, vocab, num_fields, dev) for _ in range(8)]
    sps = time_step(step, state_fn(), batches)
    del batches
    extra = (_knee_extra(step, state_fn, rng, knee_batch, nnz, vocab, num_fields, dev)
             if knee_batch else {})
    sw.report(name, batch_size * sps, **extra)


def bench_sharded(sw, name, model, batch_size, nnz, vocab, lr=0.01, layout="rows",
                  knee_batch=None):
    """``parallel/train_step.py``'s step on every rank of the default group
    (one card: world size 1, ``dist_train``'s program)."""
    from fast_tffm_tpu_torch.parallel import (
        init_sharded_state,
        make_mesh,
        make_sharded_train_step,
    )

    dev = sw.device
    mesh = make_mesh(None, 1)
    state_fn = lambda: init_sharded_state(model, mesh, _gen(dev), table_layout=layout)  # noqa: E731
    step = make_sharded_train_step(model, lr, mesh, table_layout=layout)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, batch_size, nnz, vocab, 0, dev) for _ in range(8)]
    sps = time_step(step, state_fn(), batches)
    del batches
    extra = (_knee_extra(step, state_fn, rng, knee_batch, nnz, vocab, 0, dev)
             if knee_batch else {})
    sw.report(name, batch_size * sps, **extra)


def _gen_tools():
    """tools/gen_synthetic.py (numpy only; repo-root tools/ is no package)."""
    tools = os.path.join(HERE, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import gen_synthetic

    return gen_synthetic


def synthetic_files(td: str, full: bool = False) -> dict:
    """The text files the sweep reads, bench_all.py's ``generate`` calls
    (the same sizes and seeds): Criteo-shaped 39-feature files over VOCAB
    for the input and end-to-end rows, planted-model files over CONV_VOCAB
    for the convergence pair.  One tools/torch_gen_synthetic.py process each
    (tools/gen_synthetic.py's command line and bytes), all
    started together and all finished before any timed section runs (the
    sections time only their own loops).  Returns {name: path}."""
    import subprocess

    planted = ["--factor-num", "4", "--spread", "3.0"]
    heldout = HELDOUT_FULL_ROWS if full else HELDOUT_ROWS
    jobs = {
        "input": (INPUT_ROWS, VOCAB, 0, []),
        "e2e": (E2E_ROWS, VOCAB, 0, []),
        "fit": (FIT_ROWS, CONV_VOCAB, 0, ["--factor-num", "4"]),
        "heldout_train": (heldout, CONV_VOCAB, 0, planted),
        "heldout_test": (HELDOUT_TEST_ROWS, CONV_VOCAB, 1, planted),
    }
    script = os.path.join(HERE, "tools", "torch_gen_synthetic.py")
    paths, procs = {}, []
    try:
        for name, (rows, vocab, seed, extra) in jobs.items():
            paths[name] = os.path.join(td, f"{name}.libsvm")
            procs.append(subprocess.Popen(
                [sys.executable, script, "--out", paths[name], "--rows", str(rows),
                 "--fields", "39", "--vocab", str(vocab), "--seed", str(seed), *extra],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        failed = [err for p in procs for _, err in [p.communicate()] if p.returncode]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(f"tools/torch_gen_synthetic.py failed: {failed[0][-300:]}")
    return paths


def bench_predict(sw):
    """Inference throughput at config #1's shape: gather + scorer + sigmoid."""
    from fast_tffm_tpu_torch.trainer import make_predict_step

    dev = sw.device
    model = FMModel(vocabulary_size=VOCAB, factor_num=8, order=2)
    state = init_state(model, _gen(dev))
    predict = make_predict_step(model)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, B, 39, VOCAB, 0, dev) for _ in range(8)]
    # The stream runs in order: the last scores read means every call ran.
    sps = time_step(lambda s, b: (s, predict(s, b)), state, batches,
                    sync=lambda st, out: float(out.sum()))
    sw.report("predict ex/s/chip (FM order2 k=8, nnz=39, vocab=1M)", B * sps)


def bench_input(sw, files):
    """Host input path: the generated libsvm file → C++ reader/parser →
    batches, rows/s of one host process (best of 3)."""
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream

    path = files["input"]
    parser = best_parser(os.cpu_count() or 1)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        n = 0
        for b, w in batch_stream([path], batch_size=B, vocabulary_size=VOCAB, max_nnz=39,
                                 parser=parser):
            n += int((w > 0).sum())
        best = min(best, time.perf_counter() - t0)
    sw.report("input: host libsvm rows/sec (39 feats, C++ reader+parser)", n / best,
              unit="rows/sec/host")


def bench_end_to_end_ab(sw, files):
    """Whole pipeline, text against FMB, INTERLEAVED (A B A B A B): the same
    rows through libsvm text → C++ parser → prefetch → step and through the
    FMB memmap stream → prefetch → step; medians per side and the ratio."""
    from fast_tffm_tpu_torch.data.binary import write_fmb
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.utils.prefetch import prefetch

    dev = sw.device
    path = files["e2e"]
    fmb = write_fmb(path, path + ".fmb", vocabulary_size=VOCAB, max_nnz=39)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        n = 0
        for b, w in batch_stream([fmb], batch_size=B, vocabulary_size=VOCAB, max_nnz=39):
            n += int((w > 0).sum())
        best = min(best, time.perf_counter() - t0)
    sw.report("input: FMB binary rows/sec (memmap stream)", n / best, unit="rows/sec/host")

    model = FMModel(vocabulary_size=VOCAB, factor_num=8, order=2)
    box = {"state": init_state(model, _gen(dev))}
    step = make_train_step(model, 0.05)

    def epoch(paths, parser):
        n = 0
        stream = batch_stream(paths, batch_size=B, vocabulary_size=VOCAB, max_nnz=39,
                              parser=parser)
        gen = ((Batch.from_parsed(p, w, dev, with_fields=False), w) for p, w in stream)
        state = box["state"]
        for b, w in prefetch(gen, depth=8):
            state, _ = step(state, b)
            n += int((w > 0).sum())
        forced_sync(state)
        box["state"] = state
        return n

    parser = best_parser(os.cpu_count() or 1)
    epoch([path], parser)  # warm: kernels built, file cache
    epoch([fmb], None)
    t_text, t_fmb = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        n_text = epoch([path], parser)
        t_text.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        n_fmb = epoch([fmb], None)
        t_fmb.append(time.perf_counter() - t0)
    text_rate = n_text / statistics.median(t_text)
    fmb_rate = n_fmb / statistics.median(t_fmb)
    sw.report(
        "end-to-end: train ex/s (libsvm text -> C++ parse -> step, 1 host + 1 card, "
        "interleaved A/B)",
        text_rate, unit="examples/sec",
        fmb_interleaved=round(fmb_rate, 1), fmb_over_text=round(fmb_rate / text_rate, 3),
    )
    sw.report(
        "end-to-end: train ex/s (FMB binary -> step, 1 host + 1 card, interleaved A/B)",
        fmb_rate, unit="examples/sec",
    )


def bench_convergence(sw, files, full: bool = False):
    """Quality: the ``fit`` line (train AUC after overfitting 5k rows: a
    kernel, gradient or optimizer fault caps it) and the ``heldout`` line
    (validation AUC on a sample-limited task beside the ORACLE AUC of the
    planted model that labeled the rows; vs_baseline is the lift
    (auc − 0.5) / (oracle − 0.5)).  Both through ``training.train``."""
    from fast_tffm_tpu_torch.config import Config
    from fast_tffm_tpu_torch.data.native import best_parser
    from fast_tffm_tpu_torch.data.pipeline import batch_stream
    from fast_tffm_tpu_torch.metrics import auc
    from fast_tffm_tpu_torch.training import train

    gen_synthetic = _gen_tools()
    fields, k_hidden = 39, 4
    dev = sw.device

    def run(tr, te, vocab, epochs, bs, lr, tag):
        metrics = os.path.join(os.path.dirname(tr), f"metrics_{tag}.jsonl")
        cfg = Config(
            model="fm", factor_num=8, vocabulary_size=vocab,
            model_file=os.path.join(os.path.dirname(tr), f"m_{tag}.ckpt"),
            train_files=(tr,), validation_files=(te,), epoch_num=epochs, batch_size=bs,
            learning_rate=lr, log_every=10**9, metrics_path=metrics, binary_cache=True,
        ).validate()
        train(cfg, log=lambda *_: None, device=dev)
        with open(metrics) as f:
            aucs = [r["validation_auc"] for r in map(json.loads, f) if "validation_auc" in r]
        return max(aucs)

    def oracle_auc(path, vocab):
        labels, scores = [], []
        for b, w in batch_stream([path], batch_size=8192, vocabulary_size=vocab, max_nnz=fields,
                                 parser=best_parser(1)):
            n = int((w > 0).sum())
            scores.append(gen_synthetic.planted_score(np.asarray(b.ids)[:n], b.vals[:n],
                                                      factor_num=k_hidden))
            labels.append(b.labels[:n])
        return auc(np.concatenate(labels), np.concatenate(scores))

    fit_tr = files["fit"]
    fit = run(fit_tr, fit_tr, CONV_VOCAB, epochs=FIT_EPOCHS, bs=512, lr=0.5, tag="fit")
    sw.report(f"convergence fit: train AUC (FM k=8, {FIT_ROWS // 1000}k rows, "
              f"{FIT_EPOCHS} epochs)", fit, unit="AUC (target ~1.0)", vs_baseline=round(fit, 4))

    heldout_rows = HELDOUT_FULL_ROWS if full else HELDOUT_ROWS
    te = files["heldout_test"]
    learned = run(files["heldout_train"], te, CONV_VOCAB, epochs=4, bs=1024, lr=0.5, tag="gen")
    oracle = oracle_auc(te, CONV_VOCAB)
    lift = round((learned - 0.5) / max(oracle - 0.5, 1e-9), 4)
    extra = {"measured_slice_this_run": {
        "rows": heldout_rows, "heldout_auc": round(float(learned), 5),
        "oracle_auc": round(float(oracle), 5), "lift_vs_oracle": lift,
    }}
    value, unit = learned, f"AUC (oracle ceiling {oracle:.5f})"
    name = (f"convergence heldout: AUC (FM k=8, {heldout_rows} Zipf CTR rows; no "
            f"{os.path.basename(SCALING_STUDY)}: value is this run's budget slice)")
    # The standard fields tell the converged story (bench_all.py's reason):
    # the study's largest point, on the identical config; this run's slice
    # stays under measured_slice_this_run.
    if os.path.exists(SCALING_STUDY):
        with open(SCALING_STUDY) as f:
            pts = json.load(f)["points"]
        final = max(pts, key=lambda p: p["rows"])
        extra["scaling_curve"] = [{k: p[k] for k in ("rows", "heldout_auc", "oracle_auc", "gap")}
                                  for p in pts]
        extra["converged_source"] = (f"{os.path.basename(SCALING_STUDY)} "
                                     "(tools/torch_scaling_study.py, identical config)")
        extra["converged_gap_to_oracle"] = final["gap"]
        value, lift = final["heldout_auc"], final["lift_vs_oracle"]
        unit = f"AUC (oracle ceiling {final['oracle_auc']:.5f})"
        name = (f"convergence heldout: AUC at convergence (FM k=8, {final['rows']} Zipf CTR "
                f"rows, {os.path.basename(SCALING_STUDY)}; this sweep's {heldout_rows}-row "
                "slice under measured_slice_this_run)")
    sw.report(name, value, unit=unit, vs_baseline=lift, **extra)


def bench_quality_zoo(sw):
    """The model-zoo convergence artifact (``tools/torch_quality_zoo.py``:
    FFM, order-3 FM and DeepFM-vs-FM held-out AUC against planted-oracle
    ceilings, measured on the card) as quality rows; a sweep without the
    artifact omits them rather than re-paying the training."""
    if not os.path.exists(QUALITY_ZOO):
        return
    with open(QUALITY_ZOO) as f:
        zoo = json.load(f)
    label = {
        "ffm": f"cfg3 quality: held-out AUC (FFM k={zoo['k']}, planted FFM "
               f"signal, {zoo['rows']} rows)",
        "fm3": f"cfg5 quality: held-out AUC (FM order-3 k={zoo['k']}, planted "
               f"ANOVA-3 signal, {zoo['rows']} rows)",
        "deepfm": f"cfg4 quality: held-out AUC (DeepFM, planted nonlinear "
                  f"signal, {zoo['rows']} rows)",
    }
    for fam, rec in zoo["families"].items():
        oracle = rec["oracle_auc"]
        lift = round((rec["heldout_auc"] - 0.5) / max(oracle - 0.5, 1e-9), 4)
        extra = {k: v for k, v in rec.items() if k != "heldout_auc"}
        extra["source"] = (f"{os.path.basename(QUALITY_ZOO)} (tools/torch_quality_zoo.py, "
                           f"{zoo['card']})")
        sw.report(label.get(fam, fam), rec["heldout_auc"],
                  unit=f"AUC (oracle ceiling {oracle:.5f})", vs_baseline=lift, **extra)


def main(argv=None) -> int:
    import argparse

    from fast_tffm_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="BENCH_ALL_TORCH.json", help="artifact path")
    ap.add_argument("--full", action="store_true",
                    help="2.4M-row held-out convergence point instead of 600k rows")
    ap.add_argument("--device", default=None, help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sw = Sweep(args.out, " --full" if args.full else "", dev)
    with tempfile.TemporaryDirectory(prefix="bench_all_") as td:
        try:
            files = synthetic_files(td, args.full)
        except (OSError, RuntimeError) as e:
            files = {}  # the sections that read them each record a FAILED row
            print(f"bench_all_torch.py: synthetic data: {e!r}", file=sys.stderr)
        return _sweep(sw, files, args)


def _sweep(sw, files, args) -> int:
    sw.guard(bench_local, "cfg1: train ex/s/chip (FM order2 k=8, nnz=39, vocab=1M)",
             FMModel(vocabulary_size=VOCAB, factor_num=8, order=2), B, 39, VOCAB, lr=0.05)
    sw.guard(bench_sharded,
             "cfg2: train ex/s/chip (FM order2 k=16, nnz=39, vocab=16M, row-sharded mesh)",
             FMModel(vocabulary_size=VOCAB_CFG2, factor_num=16, order=2), B, 39, VOCAB_CFG2,
             lr=0.05)
    sw.guard(bench_local, "cfg3: train ex/s/chip (FFM k=4, 22 fields, vocab=1M)",
             FFMModel(vocabulary_size=VOCAB, num_fields=22, factor_num=4),
             B // 2, 22, VOCAB, num_fields=22, lr=0.05)
    sw.guard(bench_local,
             "cfg4: train ex/s/chip (DeepFM k=8 + 3x400 MLP bf16, nnz=39, vocab=1M)",
             DeepFMModel(vocabulary_size=VOCAB, num_fields=39, factor_num=8,
                         compute_dtype="bfloat16"),
             B // 2, 39, VOCAB, lr=0.02)
    sw.guard(bench_local, "cfg5: train ex/s/chip (FM order3 k=8, nnz=11, vocab=1M, ANOVA kernel)",
             FMModel(vocabulary_size=VOCAB, factor_num=8, order=3), B, 11, VOCAB, lr=0.05)
    sw.guard(bench_predict)
    sw.guard(bench_input, files)
    sw.guard(bench_end_to_end_ab, files)
    sw.guard(bench_convergence, files, full=args.full)
    sw.guard(bench_quality_zoo)
    sw.guard(bench_local, "cfg1p: train ex/s/chip (cfg1 + table_layout=packed)",
             FMModel(vocabulary_size=VOCAB, factor_num=8, order=2), B, 39, VOCAB, lr=0.05,
             layout="packed", knee_batch=4 * B)
    sw.guard(bench_local, "cfg3p: train ex/s/chip (cfg3 FFM + table_layout=packed)",
             FFMModel(vocabulary_size=VOCAB, num_fields=22, factor_num=4),
             B // 2, 22, VOCAB, num_fields=22, lr=0.05, layout="packed", knee_batch=2 * B)
    sw.guard(bench_local,
             "cfg3pb: train ex/s/chip (cfg3p + bfloat16 interaction einsums, f32 accumulate)",
             FFMModel(vocabulary_size=VOCAB, num_fields=22, factor_num=4,
                      compute_dtype="bfloat16"),
             B // 2, 22, VOCAB, num_fields=22, lr=0.05, layout="packed", knee_batch=2 * B)
    sw.guard(bench_local, "cfg4p: train ex/s/chip (cfg4 DeepFM bf16 + table_layout=packed)",
             DeepFMModel(vocabulary_size=VOCAB, num_fields=39, factor_num=8,
                         compute_dtype="bfloat16"),
             B // 2, 39, VOCAB, lr=0.02, layout="packed", knee_batch=2 * B)
    sw.guard(bench_local, "cfg5p: train ex/s/chip (cfg5 order3 ANOVA + table_layout=packed)",
             FMModel(vocabulary_size=VOCAB, factor_num=8, order=3), B, 11, VOCAB, lr=0.05,
             layout="packed", knee_batch=4 * B)
    sw.guard(bench_sharded, "cfg2p: train ex/s/chip (cfg2 mesh step + table_layout=packed)",
             FMModel(vocabulary_size=VOCAB_CFG2, factor_num=16, order=2), B, 39, VOCAB_CFG2,
             lr=0.05, layout="packed", knee_batch=4 * B)
    sw.write()  # the final launch counts
    failed = sw.failed()
    print(json.dumps({"written": args.out, "metrics": len(sw.results), "failed": failed,
                      "kernel_launches": launch_counts()}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
