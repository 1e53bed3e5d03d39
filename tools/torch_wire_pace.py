"""The input pipeline's capacity on the FMB path, ``wire_format = packed``
against ``arrays``, across checkouts of the repo, on one card.

    python tools/torch_wire_pace.py --roots A B B A [--out FILE] [--rows N] [--device cuda]

Each root is a checkout that holds ``fast_tffm_tpu_torch/``; it runs in a
process of its own, in the order given (give A B B A, so that a drift of the
host over the call shows).  The input is the throughput epoch of
``chip_smoke.py``: ``tools/gen_synthetic.py --rows 1048576 --fields 11
--vocab 1048576 --seed 9`` (``--rows`` cuts it), cached as FMB by each root,
read as ``configs/baseline5_fm_order3_kdd.cfg`` reads it (batch 16,384, the
training stream of ``fast_tffm_tpu_torch.training`` with its converter).
For K = 1 and K = 8 and each wire format, three passes over the file are
drained by a consumer that does only what the training loop does with an
item before its step: a packed item's stream wait (``Staged.ready``, in the
stream), an arrays item's copy to the card (a batch in the stream, a K-list
into static device tensors, as the K-step graph copies it).  No step runs,
so ex/s is what the input alone can feed.  It reports ex/s per pass (from
the first item taken to the last, after a device sync) and the kind=input
fields of the last pass (``parse_ms`` and ``h2d_ms`` per item, the bytes a
step), and for the packed format a fourth pass's conversion split into
its parts (ms an item: the pack, taking a pinned buffer, the H2D dispatch,
the unpack dispatch, the hand-off event; wall clock in the converting
thread, so waits for the GIL count where they fall), prints one JSON
object, and writes it to ``--out`` too.

``--train`` instead trains each K and format over the file with
``training.train`` (no validation, no save, ``log_every`` 8, no profiler),
three rounds with the formats' order alternating, and reports each run's
logged ex/s windows and its ex/s over the wall time (set-up included).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/baseline5_fm_order3_kdd.cfg"
ROWS, NNZ, PASSES = 1 << 20, 11, 3


def _instrument(wire) -> dict:
    """Wall-clock sums of the packed converter's parts (the pack, taking a
    pinned buffer, the H2D dispatch, the unpack dispatch, the hand-off
    event), wrapped around ``data/wire.py``'s functions."""
    sums = {"pack": 0.0, "buffer": 0.0, "ship": 0.0, "unpack": 0.0, "staged": 0.0}

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sums[key] += time.perf_counter() - t0
        return run

    wire.pack_into = timed("pack", wire.pack_into)
    for key in ("buffer", "ship", "staged"):
        setattr(wire.PinnedStager, key, timed(key, getattr(wire.PinnedStager, key)))
    make = wire.make_unpacker
    wire.make_unpacker = lambda spec: timed("unpack", make(spec))
    return sums


def pace_root(root: str, data: str, device: str) -> dict:
    """One root's passes (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from fast_tffm_tpu_torch import training
    from fast_tffm_tpu_torch.data import wire
    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache

    if not training.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {training.__file__}, not the checkout at {root}")
    base = load_config(os.path.join(HERE, CONFIG))
    t0 = time.perf_counter()
    (fmb,) = ensure_fmb_cache([data], vocabulary_size=base.vocabulary_size, max_nnz=NNZ,
                              log=lambda *a: None)
    out = {"root": root, "fmb_convert_s": time.perf_counter() - t0}
    for k in (1, 8):
        for fmt in ("arrays", "packed"):
            cfg = dataclasses.replace(base, train_files=(data,), validation_files=(),
                                      binary_cache=True, steps_per_call=k,
                                      wire_format=fmt).validate()
            model = build_model(cfg)
            static = {}
            rates, rec, parts = [], {}, {}
            for i in range(PASSES + (fmt == "packed")):
                # A packed format's last pass is timed by parts (not in rates).
                sums = _instrument(wire) if i == PASSES else None
                convert = training._wire_converter(cfg, model, NNZ, torch.device(device), None)
                src = training._to_batches(
                    training._stream(cfg, cfg.train_files, NNZ, None, steps_per_call=k,
                                     log=lambda *a: None, convert=convert),
                    model, torch.device(device))
                examples, t_first = 0, None
                for batch, ex in src:
                    if t_first is None:
                        t_first = time.perf_counter()
                    else:
                        examples += ex
                    for f in dataclasses.fields(batch):
                        t = getattr(batch, f.name)
                        if t.device.type != torch.device(device).type:
                            key = (f.name, tuple(t.shape))
                            if key not in static:
                                static[key] = torch.empty_like(t, device=device)
                            static[key].copy_(t, non_blocking=True)
                if device == "cuda":
                    torch.cuda.synchronize()
                if sums is not None:
                    items = src.stats.drain()["input_items"]
                    parts = {key: 1e3 * v / items for key, v in sums.items()}
                    continue
                rates.append(examples / (time.perf_counter() - t_first))
                rec = src.stats.drain()
            out[f"{fmt}_k{k}"] = {
                "examples_per_s": rates,
                "convert_parts_ms": parts,
                **{key: rec.get(key) for key in ("input_items", "parse_ms", "h2d_ms",
                                                 "wire_bytes_per_step")},
            }
    return out


def train_root(root: str, data: str, device: str, rounds: int = 3) -> dict:
    """``training.train`` over the whole file for each K and wire format,
    ``rounds`` times with the formats' order alternating, no profiler: the
    logged ex/s windows (``log_every`` 8 steps) and the run's ex/s from
    its wall time (set-up included)."""
    sys.path.insert(0, os.path.abspath(root))
    from fast_tffm_tpu_torch import training
    from fast_tffm_tpu_torch.config import load_config

    if not training.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {training.__file__}, not the checkout at {root}")
    base = load_config(os.path.join(HERE, CONFIG))
    out = {"root": root}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(rounds):
            for k in (1, 8):
                fmts = ("packed", "arrays") if r % 2 == 0 else ("arrays", "packed")
                for fmt in fmts:
                    cfg = dataclasses.replace(
                        base, train_files=(data,), validation_files=(), predict_files=(),
                        binary_cache=True, steps_per_call=k, wire_format=fmt, log_every=8,
                        save_every_epochs=0, model_file=os.path.join(tmp, f"{fmt}{k}{r}.ckpt"),
                    ).validate()
                    lines = []
                    t0 = time.perf_counter()
                    training.train(cfg, log=lambda *a: lines.append(" ".join(map(str, a))),
                                   device=device)
                    wall = time.perf_counter() - t0
                    logged = [float(t.split()[t.split().index("examples/sec") + 1]
                                    .replace(",", "")) for t in lines if "examples/sec" in t]
                    rec = out.setdefault(f"{fmt}_k{k}", {"logged": [], "run": []})
                    rec["logged"].append(logged)
                    rec["run"].append(ROWS_OF[data] / wall)
    return out


ROWS_OF: dict = {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", help="checkouts to run, in order")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    ap.add_argument("--rows", type=int, default=ROWS, help="rows of the generated file")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    ap.add_argument("--train", action="store_true",
                    help="train each K and format over the file instead (no profiler)")
    ap.add_argument("--pace", default="", help=argparse.SUPPRESS)  # one root, in a child
    ap.add_argument("--data", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.pace:
        ROWS_OF[args.data] = args.rows
        run = train_root if args.train else pace_root
        print(json.dumps(run(args.pace, args.data, args.device)))
        return 0
    if not args.roots:
        ap.error("--roots is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=False).stdout if args.device == "cuda" else ""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        text = os.path.join(tmp, "pace.train.libsvm")
        subprocess.run([sys.executable, os.path.join(HERE, "tools", "gen_synthetic.py"),
                        "--rows", str(args.rows), "--vocab", str(1 << 20), "--out", text,
                        "--fields", str(NNZ), "--seed", "9"],
                       check=True, stdout=subprocess.DEVNULL)
        for i, root in enumerate(args.roots):
            # A copy of the root's own: each builds its FMB cache beside it.
            data = os.path.join(tmp, f"pace{i}.train.libsvm")
            shutil.copyfile(text, data)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--pace", root,
                                   "--data", data, "--device", args.device,
                                   "--rows", str(args.rows)] + ["--train"] * args.train,
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result = {"card": smi.strip(), "rows": args.rows, "runs": runs}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        tmp_out = f"{args.out}.{os.getpid()}.tmp"
        with open(tmp_out, "w") as f:
            f.write(text + "\n")
        os.replace(tmp_out, args.out)  # a reader sees the whole file or none
    return 0


if __name__ == "__main__":
    sys.exit(main())
