"""The comparison that decides ``correct`` for a training cell.

Set-up drives the port through its first calls on batches 0, 1-2 and 3 to
3 + K - 1 (one step, two, and one whole K-step call, each through the
window's own call on the resident epoch), snapshotting the state after
each.  Once the window has closed and the port's state is freed, the
plain reference (``benchmark.reference``) follows the same steps from the
benchmark's starting weights, and three numbers are read:

* ``loss_gap``: over every checked step, the largest |L_port - L_ref| /
  |L_ref| of the data loss;
* ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from the port's state after one step, g = (θ0 - θ1)·√acc1 / lr; per
  leaf |‖g_port‖ - ‖g_ref‖| / max(‖g_ref‖ of the leaf, of the median
  leaf), the worst leaf;
* ``change_gap``: the same gap of the norms of the parameters' change
  θ_t - θ0 after 3 steps and after the whole first call, the worst leaf
  and step.  Leaves whose reference gradient is under a thousandth of the
  median leaf's are left out.

The leaves are the table's bias column, its factor columns (over the rows
the checked batches touch), and each dense leaf.
A number's limit is in ``benchmark/limits/<cell>.json``, set from the
readings recorded in PERF.md.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import torch

__all__ = ["NUMBERS", "LEAF_FLOOR", "check_plan", "snapshot_steps", "leaves", "readings", "load_limits", "judge"]

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
LEAF_FLOOR = 1e-3  # a leaf's reference gradient under this share of the median leaf's


def check_plan(k: int) -> list[list[int]]:
    """The batch indices of the checked calls: one step, two, one K-step call."""
    return [[0], [1, 2], list(range(3, 3 + k))]


def snapshot_steps(k: int) -> list[int]:
    """The step counts after which the state is snapshotted: the end of
    each checked call."""
    plan = check_plan(k)
    return [sum(len(c) for c in plan[:i + 1]) for i in range(len(plan))]


def leaves(table: torch.Tensor, dense: dict) -> dict[str, torch.Tensor]:
    """The compared leaves, float64 on the host."""
    out = {"table.bias": table[:, :1], "table.factors": table[:, 1:]}
    out.update(dense)
    return {k: v.detach().double().cpu() for k, v in out.items()}


def _accum_leaves(accum: torch.Tensor, table_width: int, dense_accum: dict) -> dict:
    """The accumulators shaped as ``leaves``: a [n, 1] row accumulator
    serves every column of its row."""
    if accum.shape[-1] == 1:
        accum = accum.expand(-1, table_width)
    return leaves(accum, dense_accum)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.reshape(-1)))


def _gap(prog: dict, ref: dict, names) -> dict:
    """Per leaf |prog - ref| / max(ref, the median leaf's ref); a gap that
    is not a number (a NaN on either side) reads infinite."""
    med = statistics.median(ref[k] for k in names)
    out = {}
    for k in names:
        den = max(ref[k], med)
        gap = abs(prog[k] - ref[k]) / den if den > 0 else (0.0 if prog[k] == ref[k] else math.inf)
        out[k] = gap if gap == gap else math.inf
    return out


def readings(cfg: dict, prog: dict, ref: dict) -> dict:
    """The three numbers for a run (``prog``: the port's losses and
    snapshots, keyed by step) against the reference's ``reference_steps``
    output."""
    lr = float(cfg["learning_rate"])
    losses_p, losses_r = prog["losses"], ref["losses"]
    if len(losses_p) != len(losses_r):
        raise ValueError(f"{len(losses_p)} port losses against {len(losses_r)} reference steps")
    loss_gap = max(abs(p - r) / abs(r) if math.isfinite(p) and math.isfinite(r) else math.inf
                   for p, r in zip(losses_p, losses_r))

    theta0 = leaves(ref["table0"], ref["dense0"])
    width = ref["table0"].shape[1]
    s1 = prog["snaps"][1]
    theta1 = leaves(s1["table"], s1["dense"])
    acc1 = _accum_leaves(s1["accum"], width, s1["dense_accum"])
    g_prog = {k: _norm((theta0[k] - theta1[k]) * torch.sqrt(acc1[k]) / lr) for k in theta0}
    g_ref = {k: _norm(v) for k, v in leaves(ref["grad1"]["table"],
                                             {k: ref["grad1"][k] for k in ref["dense0"]}).items()}
    names = list(theta0)
    grad_gap = max(_gap(g_prog, g_ref, names).values())

    med_g = statistics.median(g_ref.values())
    kept = [k for k in names if g_ref[k] >= LEAF_FLOOR * med_g]
    change_gap = 0.0
    for t in sorted(ref["snaps"]):
        if t == 1:
            continue
        sp, sr = prog["snaps"][t], ref["snaps"][t]
        lp, lr_ = leaves(sp["table"], sp["dense"]), leaves(sr["table"], sr["dense"])
        c_prog = {k: _norm(lp[k] - theta0[k]) for k in kept}
        c_ref = {k: _norm(lr_[k] - theta0[k]) for k in kept}
        change_gap = max(change_gap, *_gap(c_prog, c_ref, kept).values())
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def load_limits(cell: str, root: str) -> dict:
    with open(os.path.join(root, "limits", f"{cell}.json")) as f:
        limits = json.load(f)["limits"]
    missing = [n for n in NUMBERS if n not in limits]
    if missing:
        raise ValueError(f"limits/{cell}.json lacks {missing}")
    return limits


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is not finite is given as null and fails."""
    table = {n: {"value": numbers[n] if math.isfinite(numbers[n]) else None, "limit": limits[n]}
             for n in NUMBERS}
    ok = all(v["value"] is not None and v["value"] <= v["limit"] for v in table.values())
    return ok, table
