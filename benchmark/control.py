"""The readings a cell's limits are set from, on the card at the cell's own
size, every seed in one process (the benchmark's own runs do not run this):

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 ... [--kinds ...]

For each seed: the port's set-up and checked first calls exactly as a
run makes them (``harness.prepare``), then the comparison's three numbers
for each kind:

* ``program``: the port against the reference (sound runs: the lower
  reading);
* ``control``: the reference in the port's place, computed one precision
  step below the configuration's (``reference.common.lower_precision``);
* ``control_mlp``: the same with only the MLP's operands one step below
  (fp8 for bfloat16) and every other sum as stated
  (``reference.common.lower_mlp_precision``); read only where the
  configuration has a bfloat16 MLP;
* ``half_batch``: the reference in the port's place with the second half
  of every batch left out and the mean taken over the rest;
* ``unchanged``: the reference in the port's place returning the state
  unchanged from every step.

``--kinds`` picks the planted kinds (all by default).  Prints one JSON
line a seed, then a summary: each number's largest program reading and
each planted kind's smallest.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import benchmark.run  # noqa: E402,F401  (the caches inside the checkout, as a run sets them)
import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402
from benchmark.reference import common as ref  # noqa: E402

PLANTED = ("control", "control_mlp", "half_batch", "unchanged")


def seed_readings(spec: dict, seed: int, dev, kinds=PLANTED) -> dict:
    """The port's three numbers at one seed (``program``), and each planted
    kind's in ``kinds`` that applies to the configuration."""
    cfg = spec["config"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog, epoch, checked, first = harness.prepare(spec, seed, dev)
    del prog, epoch
    harness.release(dev)
    keep = check.snapshot_steps(harness.cell_shape(spec)[2])
    followed = ref.reference_steps(cfg, checked, seed, dev, ref.config_precision(cfg), keep)
    out = {"program": check.readings(cfg, first, followed)}
    planted = {"control": (ref.lower_precision(cfg), None),
               "control_mlp": (ref.lower_mlp_precision(cfg), None),
               "half_batch": (ref.config_precision(cfg), "half_batch"),
               "unchanged": (ref.config_precision(cfg), "unchanged")}
    for kind in kinds:
        prec, fault = planted[kind]
        if prec is None:
            continue
        other = ref.reference_steps(cfg, checked, seed, dev, prec, keep, fault=fault)
        out[kind] = check.readings(cfg, other, followed)
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=list(PLANTED), choices=PLANTED)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = seed_readings(spec, seed, torch.device("cuda"), args.kinds)
        rows.append(r)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **r}), flush=True)
    summary = {}
    for kind in ["program", *args.kinds]:
        if kind not in rows[0]:
            continue
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(r[kind][n] for r in rows) for n in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
