"""A/B timing of kernel B4 (``fast_tffm_tpu_torch/csrc/rows_tail_adagrad.cu``)
on the rows layout, across checkouts of the repo, on one card.

    python tools/torch_b4_ab.py --roots A B B A [--out FILE]

Each root is a checkout that holds ``fast_tffm_tpu_torch/``; it is timed in
a process of its own, which builds the kernel from that checkout's
``csrc/`` into its ``_build/``, in the order given (give A B B A, so that
a drift of the card's clock over the call shows).  The input is baseline5's
first training batch as ``chip_smoke.py`` draws it: ``tools/gen_synthetic.py``
with 393,216 rows, ``--fields 11 --seed 7``, its first 16,384 rows parsed
into 2^20 rows (M = 180,224 occurrences, D = 9), and the gradients, the
table and the element [V, 9] and row [V, 1] accumulators drawn from one
numpy seed.  For each root and accumulator it reports the kernel's device
time on the sort's output (the median profiler duration of 30 calls,
L2-warm; None when a trace holds no kernel event), the wall time per call
over 100 calls between CUDA events, the build's registers and spill bytes
(``-Xptxas=-v``) and a digest of the arrays after the first call, which
must agree across roots (every version is bitwise its plain twin).  It
prints one JSON object, writes it to ``--out`` too, and exits 1 if a
digest differs.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, BATCH, NNZ, D, LR, SEED = 1 << 20, 16384, 11, 9, 0.05, 20261016


def _ptxas(log: str) -> dict:
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?([a-z][a-z_]*_kernel)(?:IL[ib](\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _device_ms(fn, reps: int, name: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    durs = sorted(float(e["dur"]) for e in events
                  if str(e.get("cat", "")).lower() == "kernel" and name in e.get("name", ""))
    return durs[len(durs) // 2] / 1e3 if durs else None


def _event_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_root(root: str, data: str) -> dict:
    """One root's build and timings (run in a process of its own)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.ops import kernel_build

    if not kernel_build.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {kernel_build.__file__}, not the checkout at {root}")
    build = kernel_build.build(["rows_tail_adagrad"])["rows_tail_adagrad"]
    from fast_tffm_tpu_torch.data.libsvm import parse_lines
    from fast_tffm_tpu_torch.ops.tail import rows_tail_sorted

    with open(data) as f:
        lines = list(itertools.islice(f, BATCH))
    ids = torch.from_numpy(
        parse_lines(lines, vocabulary_size=VOCAB, max_nnz=NNZ).ids.astype(np.int32)).cuda()
    rng = np.random.default_rng(SEED)
    grads = torch.from_numpy(
        (rng.normal(size=(BATCH * NNZ, D)) * 1e-3).astype(np.float32)).cuda()
    table = torch.from_numpy(rng.uniform(-0.01, 0.01, (VOCAB, D)).astype(np.float32)).cuda()
    accums = {
        "element": torch.from_numpy(rng.uniform(0.1, 0.5, (VOCAB, D)).astype(np.float32)).cuda(),
        "row": torch.from_numpy(rng.uniform(0.1, 0.5, (VOCAB, 1)).astype(np.float32)).cuda(),
    }
    sid, order = torch.sort(ids.reshape(-1), stable=True)
    out = {"root": root, "build_s": build["seconds"], "ptxas": _ptxas(build["log"])}
    for acc, accum in accums.items():
        t, a = table.clone(), accum.clone()
        rows_tail_sorted(t, a, sid, order, grads, LR)
        torch.cuda.synchronize()
        digest = hashlib.sha256(t.cpu().numpy().tobytes() + a.cpu().numpy().tobytes())
        kernel = lambda: rows_tail_sorted(t, a, sid, order, grads, LR)  # noqa: E731
        out[acc] = {
            "device_ms": _device_ms(kernel, 30, f"rows_{acc}_kernel"),
            "event_ms": _event_ms(kernel, 100),
            "digest": digest.hexdigest()[:16],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", help="checkouts to time, in order")
    ap.add_argument("--out", default="", help="also write the JSON result here")
    ap.add_argument("--time", default="", help=argparse.SUPPRESS)  # one root, in a child
    ap.add_argument("--data", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time:
        print(json.dumps(time_root(args.time, args.data)))
        return 0
    if not args.roots:
        ap.error("--roots is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "baseline5.train.libsvm")
        subprocess.run([sys.executable, os.path.join(HERE, "tools", "gen_synthetic.py"),
                        "--rows", str(24 * BATCH), "--vocab", str(VOCAB), "--out", data,
                        "--fields", str(NNZ), "--seed", "7"],
                       check=True, stdout=subprocess.DEVNULL)
        for root in args.roots:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root,
                                   "--data", data], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    digests = {(r["element"]["digest"], r["row"]["digest"]) for r in runs}
    result = {"card": smi.strip(), "runs": runs, "digests_agree": len(digests) == 1}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        tmp_out = f"{args.out}.{os.getpid()}.tmp"
        with open(tmp_out, "w") as f:
            f.write(text + "\n")
        os.replace(tmp_out, args.out)  # a reader sees the whole file or none
    return 0 if result["digests_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
