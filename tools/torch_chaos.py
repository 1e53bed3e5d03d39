#!/usr/bin/env python
"""Chaos probe of the PyTorch/CUDA port: supervised crash-and-resume MTTR +
loss parity, and the serving tier under replica faults — the counterpart of
``tools/chaos.py`` on ``fast_tffm_tpu_torch``, with its constants, seeds,
data and gates.

Drives the resilience layer end to end with REAL trainer subprocesses
(``python -m fast_tffm_tpu_torch.cli <mode> <cfg> ... --device D``; the
card unless ``--device cpu``, and without a card it raises):

  baseline   one uninterrupted run per path (streamed, sharded) on a
             seeded synthetic CTR set, per-step losses logged to JSONL.
  chaos      the same run under ``train --supervised`` with a seeded
             ``kill@N`` fault plan: the child SIGKILLs itself at step N,
             the supervisor relaunches it with ``--resume``, and the
             resumed child reopens the input at the checkpoint cursor.

For every trial the probe checks the acceptance pin — each step of the
uninterrupted run appears in the chaos run's concatenated log with a
bit-identical loss — and records the supervisor's measured MTTR
(crash → first new training progress in the relaunched child, backoff
included: that IS recovery time the fleet pays).

The kill steps are drawn from ``random.Random(seed)``, so a probe run is
reproducible bit for bit (the fault plan's byte-identity is separately
pinned by tests/test_resilience.py).

``--sharded`` adds the ``dist_train`` path in one process (world size 1:
the JAX tool's 8-device CPU mesh has no counterpart in one process).
Writes PROBE_MTTR_TORCH_r16.json; ``--processes 2`` chaoses the REAL
multi-process pod instead (dist_train under the pod supervisor, gloo on
the CPU, NCCL with one card per process, one SIGKILLed host per trial,
victims alternating writer/survivor) and writes
PROBE_MTTR_DIST_TORCH_r16.json.

``--serve`` (ISSUE 8) chaoses the SERVING tier instead: a live
2-replica socket front end under a FaultPlan serving schedule
(``replica_kill@N`` SIGKILLs replica N, ``replica_slow@N:MS`` injects
per-flush latency, ``reload_corrupt@N`` corrupts the checkpoint under
the reload watcher's nose and then heals it), while a steady request
stream pins the acceptance: ZERO hung or unanswered clients (every
request gets a score or a typed code), every DELIVERED score
bit-identical to a fault-free baseline run of the same request set,
replica restart MTTR measured, and zero steady-state recompiles on
every replica.  The DATA path rides the binary frame wire pinned to a
replica (serving/client.py FrameConnection) — killing the pinned replica
exercises the client's retry-once-on-peer failover — while ops stay JSONL
through the front end.  Writes PROBE_SERVE_CHAOS_TORCH_r16.json.

The artifacts' keys are the JAX tool's, plus (``ADDED_KEYS``) the port's
device stamp (``device``, ``device_name``, ``card``: ``nvidia-smi``'s name
and power limit, ``torch_version``, ``cuda_version``); the MTTR artifacts
also carry the stamp's ``run_id`` and ``schema_version``, which the JAX
tool writes too and its committed PROBE_MTTR_r06.json predates.  Every
trial, path and serving key is the JAX tool's.

Usage:
  python tools/torch_chaos.py [--trials 3] [--seed 1106] [--sharded]
                              [--processes 2] [--device cpu] [--out PROBE.json]
  python tools/torch_chaos.py --serve [--serve-plan SPEC] [--device cpu] [--out PROBE.json]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ROWS = 320
BATCH = 32
EPOCHS = 2
STEPS = ROWS // BATCH * EPOCHS  # 20
DELTA_EVERY = 3
# What the port's artifacts add to the JAX tool's keys (the device stamp).
ADDED_KEYS = ("device", "device_name", "card", "torch_version", "cuda_version")


def _write_dataset(path: str) -> None:
    import numpy as np

    rng = np.random.default_rng(7)
    lines = []
    for _ in range(ROWS):
        ids = rng.choice(64, size=4, replace=False)
        toks = " ".join(f"{i}:1.0" for i in ids)
        lines.append(f"{rng.integers(0, 2)} {toks}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _write_cfg(d: str, processes: int = 1) -> str:
    cfg = os.path.join(d, "run.cfg")
    dist = (
        f"\n[Distributed]\nnum_processes = {processes}\nbarrier_timeout_s = 60\n"
        if processes > 1
        else ""
    )
    with open(cfg, "w") as f:
        f.write(
            f"""
[General]
model = fm
factor_num = 4
vocabulary_size = 64
model_file = {d}/m.ckpt

[Checkpoint]
delta_every_steps = {DELTA_EVERY}

[Train]
train_files = {d}/t.libsvm
epoch_num = {EPOCHS}
batch_size = {BATCH}
max_nnz = 4
learning_rate = 0.1
log_every = 1
metrics_path = {d}/run.jsonl
{dist}"""
        )
    return cfg


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(
    mode: str, cfg: str, *args, device: str, timeout: int = 600
) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "fast_tffm_tpu_torch.cli", mode, cfg, *args,
         "--device", device],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
        env=_env(),
        cwd=REPO,
        timeout=timeout,
    )


def _records(path: str, kind: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("kind") == kind:
                out.append(r)
    return out


def _losses(path: str) -> dict[int, float]:
    """step -> LAST logged loss (replayed steps re-log; the last feeds
    the surviving state)."""
    return {r["step"]: r["loss"] for r in _records(path, "train")}


def _trial(
    mode: str,
    kill_at: int,
    base_losses: dict[int, float],
    device: str,
    processes: int = 1,
    victim: int = 0,
) -> dict:
    """One supervised chaos run; returns the trial record.  Pod runs
    (``processes`` > 1) SIGKILL host ``victim`` — alternating writer /
    non-writer across trials exercises both halves of the single-host
    relaunch protocol."""
    with tempfile.TemporaryDirectory(prefix="chaos-") as d:
        _write_dataset(os.path.join(d, "t.libsvm"))
        cfg = _write_cfg(d, processes)
        extra = (
            ["--fault-process", str(victim)] if processes > 1 else []
        )
        t0 = time.monotonic()
        proc = _run(
            mode, cfg, "--supervised", "--fault-plan", f"kill@{kill_at}",
            "--max-restarts", "3", *extra, device=device,
        )
        wall_s = time.monotonic() - t0
        metrics = os.path.join(d, "run.jsonl")
        out: dict = {
            "mode": mode,
            "kill_at_step": kill_at,
            "supervisor_rc": proc.returncode,
            "wall_s": round(wall_s, 3),
        }
        if processes > 1:
            out["processes"] = processes
            out["victim"] = victim
        if proc.returncode != 0:
            out["error"] = proc.stdout[-2000:]
            return out
        got = _losses(metrics)
        missing = sorted(set(base_losses) - set(got))
        mismatched = sorted(
            s for s, v in base_losses.items() if s in got and got[s] != v
        )
        faults = [
            r for r in _records(metrics, "fault") if r.get("event") == "crash"
        ]
        restarts = _records(metrics, "restart")
        # Save boundaries: every DELTA_EVERY steps plus the epoch ends —
        # the resumed child replays kill_at minus the last one before it.
        boundaries = set(range(DELTA_EVERY, STEPS + 1, DELTA_EVERY))
        boundaries.update(range(STEPS // EPOCHS, STEPS + 1, STEPS // EPOCHS))
        last_save = max((s for s in boundaries if s <= kill_at), default=0)
        out.update(
            losses_bit_identical=not missing and not mismatched,
            missing_steps=missing,
            mismatched_steps=mismatched,
            crashes=len(faults),
            restarts=len(restarts),
            replayed_steps=max(0, kill_at - last_save),
            mttr_s=[r.get("mttr_s") for r in restarts],
        )
        return out


# ---------------------------------------------------------------------------
# serving chaos (--serve): live front end + replica kill/slow/corrupt
# ---------------------------------------------------------------------------

SERVE_REPLICAS = 2
SERVE_REQUESTS = 600
SERVE_QPS = 200.0


def _serve_cfg(d: str, run_id: str = "") -> str:
    cfg = os.path.join(d, "serve.cfg")
    with open(cfg, "w") as f:
        f.write(
            f"""
[General]
model = fm
factor_num = 4
vocabulary_size = 4096
model_file = {d}/m.ckpt

[Train]
max_nnz = 6
metrics_path = {d}/serve.jsonl

[Telemetry]
run_id = {run_id}

[Serving]
buckets = 1 8 64
flush_deadline_ms = 3
replicas = {SERVE_REPLICAS}
classes = gold:2,std:1
reload_interval_s = 0.2
"""
        )
    return cfg


def _serve_checkpoint(model_file: str) -> bytes:
    """Write the serving checkpoint; returns the bytes of a CORRUPT
    would-be successor (different step, valid zip metadata, torn array
    data) — what a dying trainer's non-atomic publish leaves behind.
    Its signature and save_id still read, so the reload path ATTEMPTS
    the restore and must survive the CRC failure."""
    import dataclasses

    import torch

    from fast_tffm_tpu_torch.checkpoint import save_checkpoint
    from fast_tffm_tpu_torch.config import Config, build_model
    from fast_tffm_tpu_torch.trainer import init_state

    cfg = Config(
        model="fm", factor_num=4, vocabulary_size=4096, max_nnz=6,
        model_file=model_file,
    ).validate()
    state = init_state(
        build_model(cfg), torch.Generator().manual_seed(3), cfg.init_accumulator_value
    )
    save_checkpoint(model_file, dataclasses.replace(state, table=state.table + 0.25))
    succ = model_file + ".successor"
    save_checkpoint(
        succ, dataclasses.replace(state, table=state.table + 0.5, step=state.step + 10)
    )
    with open(succ, "rb") as f:
        b = f.read()
    os.remove(succ)
    mid = len(b) // 2
    return b[:mid] + b"\xde\xad" * 32 + b[mid + 64:]


def _serve_lines(n: int, seed: int) -> list[str]:
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        ids = rng.choice(4096, size=k, replace=False)
        vals = np.round(np.abs(rng.normal(size=k)) + 0.1, 4)
        out.append(
            f"{int(rng.integers(0, 2))} "
            + " ".join(f"{i}:{v}" for i, v in zip(ids, vals))
        )
    return out


def _client(port):
    """JSONL CONTROL connection to the front end (stats/ping/slow) — ops
    stay on the line protocol; only the DATA path rides frames."""
    from fast_tffm_tpu_torch.serving.client import ServeConnection

    return ServeConnection(port)


def _parse_serve_lines(lines):
    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    return parse_lines(lines, vocabulary_size=4096, max_nnz=6)


def _drive_frames(fc, parsed, base: int, qps: float, events=None):
    """Send every row (req_ids base+i) as a 1-row binary REQUEST frame
    at ~qps; fire ``events`` (callables keyed by send-index) along the
    way — the chaos schedule rides the request stream, so faults land
    mid-traffic.  1-row frames keep the schedule at request granularity
    AND exercise the failover resend path per request."""
    import numpy as np

    events = events or {}
    interval = 1.0 / qps
    t_next = time.perf_counter()
    for i in range(parsed.batch_size):
        if i in events:
            events[i]()
        now = time.perf_counter()
        if now < t_next:
            time.sleep(t_next - now)
        t_next += interval
        klass = "gold" if i % 10 == 0 else "std"
        fc.send_batch(
            np.array([base + i], np.uint32),
            parsed.ids[i : i + 1],
            parsed.vals[i : i + 1],
            fields=parsed.fields[i : i + 1] if fc.uses_fields else None,
            klass=klass,
        )


def _serve_chaos(args) -> int:
    from fast_tffm_tpu_torch.resilience import FaultPlan

    out_path = args.out or os.path.join(REPO, "PROBE_SERVE_CHAOS_TORCH_r16.json")
    plan = FaultPlan.parse(args.serve_plan, seed=args.seed)
    serving = plan.serving_events()
    if not serving:
        print("chaos: --serve-plan has no serving faults", file=sys.stderr)
        return 1
    lines = _serve_lines(SERVE_REQUESTS, args.seed)
    from fast_tffm_tpu_torch.telemetry import artifact_stamp, device_stamp, write_json_artifact

    result: dict = {
        "probe": "SERVE_CHAOS",
        # Envelope join keys (run_id + schema_version): this probe is
        # joinable to the telemetry JSONL its serve tier wrote.
        **artifact_stamp(),
        **device_stamp(args.device),
        "seed": args.seed,
        "plan": json.loads(plan.to_json()),
        "replicas": SERVE_REPLICAS,
        "requests": SERVE_REQUESTS,
        "qps": SERVE_QPS,
    }
    with tempfile.TemporaryDirectory(prefix="chaos-serve-") as d:
        # The tier adopts the probe's run_id (written into [Telemetry]),
        # so the stamp above genuinely joins this JSON to its JSONL.
        cfg_path = _serve_cfg(d, run_id=result["run_id"])
        model_file = os.path.join(d, "m.ckpt")
        corrupt_bytes = _serve_checkpoint(model_file)
        with open(model_file, "rb") as f:
            good_bytes = f.read()

        from fast_tffm_tpu_torch.serving.client import FrameConnection, spawn_serve

        parsed = _parse_serve_lines(lines)

        # ---- baseline: fault-free, same request set --------------------
        proc, port = spawn_serve(cfg_path, device=args.device)
        try:
            fc = FrameConnection(port)
            _drive_frames(fc, parsed, base=0, qps=SERVE_QPS)
            missing = fc.wait_answered(range(len(lines)), timeout=60)
            assert not missing, f"baseline left {len(missing)} unanswered"
            with fc.lock:
                baseline = {
                    i: (fc.results[i][1] if fc.results[i][0] == "ok" else None)
                    for i in range(len(lines))
                }
            fc.close()
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()  # a child ignoring SIGTERM must not survive
                proc.wait(timeout=5)  # reap: its port must be free below
        unscored = sum(1 for v in baseline.values() if v is None)
        result["baseline_unscored"] = unscored
        if unscored:
            print(f"chaos: baseline failed to score {unscored} requests",
                  file=sys.stderr)

        # ---- chaos run: same lines, faults mid-stream ------------------
        proc, port = spawn_serve(cfg_path, device=args.device)
        hard_fail = None
        try:
            client = _client(port)  # CONTROL (JSONL): stats/ping/slow
            fc = FrameConnection(port)  # DATA (binary, replica-pinned)
            result["wire"] = "binary"
            result["pinned_replica"] = fc.replica
            stats0 = client.request({"op": "stats"}, timeout=60)
            pids = {r["replica"]: r["pid"] for r in stats0["replicas"]}
            t_kill = [None]

            def fire(event):
                kind, at = event["kind"], event["at"]
                if kind == "replica_kill":
                    print(f"chaos: SIGKILL replica {at} (pid {pids[at]})",
                          flush=True)
                    t_kill[0] = time.monotonic()
                    os.kill(pids[at], signal.SIGKILL)
                elif kind == "replica_slow":
                    ms = event.get("until", 100)
                    print(f"chaos: slow replica {at} by {ms}ms/flush", flush=True)
                    client.send(
                        {"id": f"slow-{at}", "op": "slow", "replica": at,
                         "ms": ms, "flushes": 40}
                    )
                elif kind == "reload_corrupt":
                    # A torn NEW publish: different save_id, readable
                    # signature, corrupt array data — the watcher fans a
                    # reload that must FAIL cleanly on every replica
                    # while serving continues on the loaded state.
                    print("chaos: publishing a torn successor checkpoint",
                          flush=True)
                    # analysis: ok atomic-publish deliberate corruption injection — tearing the publish IS the fault under test
                    with open(model_file, "wb") as f:
                        f.write(corrupt_bytes)

            # Spread the schedule across the stream's middle half.
            step = max(1, SERVE_REQUESTS // (2 * (len(serving) + 1)))
            events = {
                SERVE_REQUESTS // 4 + k * step: (lambda e=e: fire(e))
                for k, e in enumerate(serving)
            }
            _drive_frames(fc, parsed, base=10_000, qps=SERVE_QPS, events=events)
            ids = [10_000 + i for i in range(len(lines))]
            missing = fc.wait_answered(ids, timeout=120)
            result["unanswered"] = len(missing)
            result["client_failovers"] = fc.failovers

            # Heal the corrupt checkpoint: the watcher must pick the good
            # bytes back up (same content ⇒ same scores) — reload
            # failures were counted while it was torn.
            if any(e["kind"] == "reload_corrupt" for e in serving):
                # analysis: ok atomic-publish healing the injected corruption in place — same deliberate-fault channel as the tear
                with open(model_file, "wb") as f:
                    f.write(good_bytes)

            with fc.lock:
                answered = dict(fc.results)
            scored = mismatched = typed = 0
            codes: dict[str, int] = {}
            for i in range(len(lines)):
                r = answered.get(10_000 + i)
                if r is None:
                    continue
                status, score = r
                if status == "ok":
                    scored += 1
                    if score != baseline.get(i):
                        mismatched += 1
                else:
                    typed += 1
                    codes[status] = codes.get(status, 0) + 1
            result.update(
                scored=scored,
                typed_errors=typed,
                typed_codes=codes,
                scores_mismatched=mismatched,
            )

            # Recovery: all replicas healthy again, MTTR on the books.
            deadline = time.monotonic() + 120
            snap = None
            while time.monotonic() < deadline:
                snap = client.request({"op": "ping"}, timeout=30)
                if all(r["state"] == "healthy" for r in snap["replicas"]):
                    break
                time.sleep(0.5)
            stats = client.request({"op": "stats"}, timeout=60)
            result["replica_restarts"] = sum(
                r["restarts"] for r in stats["replicas"]
            )
            result["mttr_s"] = stats.get("mttr_s", [])
            result["mttr_s_detection_to_healthy"] = (
                stats["mttr_s"][0] if stats.get("mttr_s") else None
            )
            if t_kill[0] is not None and stats.get("mttr_s"):
                # Kill → healthy as the CLIENT would measure it (includes
                # the router's detection latency, not just its restart).
                result["kill_observed"] = True
            steady = {}
            reload_failures = {}
            delta_or_reloads = {}
            for idx, eng in stats.get("engines", {}).items():
                steady[idx] = eng.get("steady_compiles")
                e = eng.get("engine", {})
                reload_failures[idx] = e.get("reload_failures")
                delta_or_reloads[idx] = (e.get("reloads"), e.get("delta_reloads"))
            result["steady_compiles_by_replica"] = steady
            result["reload_failures_by_replica"] = reload_failures
            result["reloads_by_replica"] = delta_or_reloads
            result["all_healthy_after"] = bool(
                snap and all(r["state"] == "healthy" for r in snap["replicas"])
            )
            fc.close()
            client.close()
        except Exception as e:  # the probe must always write its verdict
            hard_fail = repr(e)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
    ok = (
        hard_fail is None
        and result.get("baseline_unscored") == 0
        and result.get("unanswered") == 0
        and result.get("scores_mismatched") == 0
        and result.get("replica_restarts", 0) >= 1
        and result.get("all_healthy_after")
        and all(
            v == 0 for v in result.get("steady_compiles_by_replica", {}).values()
        )
    )
    if any(e["kind"] == "reload_corrupt" for e in serving):
        # The torn successor must have been ATTEMPTED and survived — a
        # probe where no replica even tried the reload tested nothing.
        ok = ok and any(
            (v or 0) >= 1
            for v in result.get("reload_failures_by_replica", {}).values()
        )
    if hard_fail:
        result["error"] = hard_fail
    result["ok"] = ok
    write_json_artifact(out_path, result)
    print(f"chaos: wrote {out_path} (ok={ok})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=3, metavar="N",
                    help="chaos trials per path (seeded kill steps)")
    ap.add_argument("--seed", type=int, default=1106)
    ap.add_argument("--sharded", action="store_true",
                    help="also run the dist_train path (one process: world size 1)")
    ap.add_argument("--processes", type=int, default=1, metavar="N",
                    help="N > 1: chaos the REAL multi-process pod instead "
                    "(dist_train under the pod supervisor, gloo on the CPU, "
                    "NCCL with one card per process; each "
                    "trial SIGKILLs one host — victims alternate between "
                    "the writer and a survivor)")
    ap.add_argument("--serve", action="store_true",
                    help="chaos the SERVING tier: a live 2-replica socket "
                    "front end under replica kill/slow/corrupt faults "
                    "(writes PROBE_SERVE_CHAOS_TORCH_r16.json)")
    ap.add_argument("--serve-plan",
                    default="replica_kill@0,replica_slow@1:150,reload_corrupt@0",
                    metavar="SPEC",
                    help="FaultPlan spec for --serve (serving kinds only; "
                    "@N is the replica index)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the children's --device (the card unless cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from fast_tffm_tpu_torch.device import resolve_device

    resolve_device(args.device)  # the card, or raise
    if args.device == "cuda" and args.processes > torch.cuda.device_count():
        raise SystemExit(
            f"chaos: a pod of {args.processes} processes on cuda needs one card per "
            f"process; this host has {torch.cuda.device_count()}"
        )
    if args.serve:
        return _serve_chaos(args)
    pod = args.processes > 1
    out_path = args.out or os.path.join(
        REPO, "PROBE_MTTR_DIST_TORCH_r16.json" if pod else "PROBE_MTTR_TORCH_r16.json"
    )

    rng = random.Random(args.seed)
    modes = (
        ["dist_train"]
        if pod
        else ["train"] + (["dist_train"] if args.sharded else [])
    )
    from fast_tffm_tpu_torch.telemetry import artifact_stamp, device_stamp, write_json_artifact

    result: dict = {
        # Envelope identity keys: the chaos trials' JSONL lives (and dies)
        # in per-trial tempdirs, so this stamp names the probe invocation;
        # the serve probe's tier ADOPTS its run_id (see _serve_chaos).
        **artifact_stamp(),
        **device_stamp(args.device),
        "steps_total": STEPS,
        "delta_every_steps": DELTA_EVERY,
        "seed": args.seed,
        "paths": {},
    }
    if pod:
        result["processes"] = args.processes
    ok = True
    for mode in modes:
        with tempfile.TemporaryDirectory(prefix="chaos-base-") as d:
            _write_dataset(os.path.join(d, "t.libsvm"))
            t0 = time.monotonic()
            proc = _run(
                mode, _write_cfg(d, args.processes),
                *(["--supervised"] if pod else []),
                device=args.device,
            )
            if proc.returncode != 0:
                print(proc.stdout[-2000:], file=sys.stderr)
                print(f"chaos: {mode} baseline failed rc={proc.returncode}",
                      file=sys.stderr)
                return 1
            base_wall = time.monotonic() - t0
            base_losses = _losses(os.path.join(d, "run.jsonl"))
        assert len(base_losses) == STEPS, (
            f"baseline logged {len(base_losses)} steps, wanted {STEPS}"
        )
        trials = []
        for i in range(max(1, args.trials)):
            kill_at = rng.randrange(4, STEPS - 3)
            victim = i % args.processes if pod else 0
            label = f" victim=host{victim}" if pod else ""
            print(f"chaos: {mode} kill@{kill_at}{label} ...", flush=True)
            trials.append(
                _trial(mode, kill_at, base_losses, args.device,
                       processes=args.processes, victim=victim)
            )
        mttrs = [
            m for t in trials for m in t.get("mttr_s", [])
            if isinstance(m, (int, float))
        ]
        path_ok = all(
            t.get("supervisor_rc") == 0 and t.get("losses_bit_identical")
            for t in trials
        )
        ok = ok and path_ok
        result["paths"][mode] = {
            "baseline_wall_s": round(base_wall, 3),
            "trials": trials,
            "mttr_s_median": round(statistics.median(mttrs), 3) if mttrs else None,
            "mttr_s_max": round(max(mttrs), 3) if mttrs else None,
            "all_losses_bit_identical": path_ok,
        }
    write_json_artifact(out_path, result)
    print(f"chaos: wrote {out_path} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
