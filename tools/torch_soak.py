#!/usr/bin/env python
"""Sustained online-learning soak of the PyTorch/CUDA port: trainer +
publisher + loaded fleet, with chaos — the counterpart of ``tools/soak.py``
on ``fast_tffm_tpu_torch``, with its constants, fault plans, sentinels and
gates.

The production soak test ROADMAP item 4 names: every piece of the online
loop exists (delta publish, replicated serving with exactly-once reload
fan-out, freshness SLOs, supervised restart), but nothing had ever run
them CONCURRENTLY for a sustained window under load and live faults.
This harness does, end to end, with only repo machinery:

  * an event WRITER appends rows to an FMS stream at an open-loop rate,
    executing the stream-tier FaultPlan kinds (``stream_stall@N`` — the
    writer goes silent N seconds; ``append_torn@K`` — the Kth append
    leaves a torn trailing record for a while);
  * the ONLINE TRAINER (``python -m fast_tffm_tpu_torch.cli train
    --supervised --resume --device D``)
    tail-follows the stream with ``delta_every_steps`` publishing
    continuously and async full saves; its FaultPlan SIGKILLs it
    mid-run (supervised restart + exact mid-stream resume) and tears a
    delta write (chain repair);
  * a SERVING FLEET (``cli serve --port --device D`` → router + N
    replica workers)
    hot-applies the delta chain while an open-loop load client scores
    against it; full mode SIGKILLs one replica mid-traffic (failover)
    — every admitted request must still get exactly one response;
  * the SENTINEL loop polls the ``stats`` wire op and the checkpoint
    chain every tick and emits one ``kind=soak`` record per tick:
    trainer alive (or cleanly restarting), zero unanswered requests so
    far, fleet freshness within the SLO envelope, delta chain length
    and on-disk footprint bounded (the age/size compaction invariant),
    zero steady-state recompiles on every replica.

Writes PROBE_SOAK JSON (the committed artifact) and exits nonzero if
any sentinel failed.  ``--smoke`` is the ~30 s miniature wired into
tier-1 (1 replica, 1 trainer kill + stream stall, all sentinels live);
the full run is ``--minutes 10`` (slow, the committed probe).  The
trainer and the fleet run on ``--device`` (the card unless ``--device
cpu``; without a card it raises).

The artifact's keys are the JAX tool's plus (``ADDED_KEYS``) the port's
device stamp: ``device``, ``device_name``, ``card`` (``nvidia-smi``'s name
and power limit), ``torch_version``, ``cuda_version``.  One difference in
what a key means: the run's window (``--minutes``, ``duration_s``, the
ticks' ``elapsed_s``, the replica-kill schedule) starts once the fleet is
up, where the JAX tool starts it before the bring-up.  On the card the
bring-up (the seed run, the fleet's CUDA starts) takes ~20 s, which would
leave a smoke's 27 s window without traffic.

Usage:
    python tools/torch_soak.py --minutes 10 --replicas 2 --qps 250
    python tools/torch_soak.py --smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

VOCAB = 1 << 12
WIDTH = 6
K = 4
# What the port's artifact adds to the JAX tool's keys (the device stamp).
ADDED_KEYS = ("device", "device_name", "card", "torch_version", "cuda_version")


def _synth_batch(rng, rows: int):
    """One append's worth of synthetic rows (mixed nnz 1..WIDTH so the
    serving ladder and the trainer see every width)."""
    nnz = rng.integers(1, WIDTH + 1, size=rows)
    ids = np.zeros((rows, WIDTH), np.int64)
    vals = np.zeros((rows, WIDTH), np.float32)
    for r in range(rows):
        k = int(nnz[r])
        ids[r, :k] = rng.choice(VOCAB, size=k, replace=False)
        vals[r, :k] = np.round(np.abs(rng.normal(size=k)) + 0.1, 4)
    labels = rng.integers(0, 2, size=rows)
    return labels, ids, vals, nnz


def _score_lines(rng, n: int) -> list[str]:
    out = []
    for _ in range(n):
        k = int(rng.integers(1, WIDTH + 1))
        ids = rng.choice(VOCAB, size=k, replace=False)
        vals = np.round(np.abs(rng.normal(size=k)) + 0.1, 4)
        out.append(
            f"{int(rng.integers(0, 2))} "
            + " ".join(f"{i}:{v}" for i, v in zip(ids, vals))
        )
    return out


def _train_cfg(d: str, run_id: str, a) -> str:
    path = os.path.join(d, "train.cfg")
    with open(path, "w") as f:
        f.write(
            f"""
[General]
model = fm
factor_num = {K}
vocabulary_size = {VOCAB}
model_file = {d}/m.ckpt

[Train]
train_files = {d}/stream.fms
max_nnz = {WIDTH}
batch_size = {a.batch_size}
epoch_num = 1
learning_rate = 0.05
log_every = {a.log_every}
metrics_path = {d}/trainer.jsonl

[Online]
follow = true
poll_s = 0.05
idle_timeout_s = {a.idle_timeout_s}
adagrad_decay = {a.decay}

[Checkpoint]
async_save = true
delta_every_steps = {a.delta_every_steps}
delta_chain_max = {a.chain_max}
full_every_s = {a.full_every_s}

[Telemetry]
run_id = {run_id}
stall_timeout_s = {a.stall_timeout_s}

[Resilience]
restart_max = 6
restart_backoff_s = 0.2
restart_backoff_max_s = 2.0
"""
        )
    return path


def _serve_cfg(d: str, run_id: str, a) -> str:
    path = os.path.join(d, "serve.cfg")
    with open(path, "w") as f:
        f.write(
            f"""
[General]
model = fm
factor_num = {K}
vocabulary_size = {VOCAB}
model_file = {d}/m.ckpt

[Train]
max_nnz = {WIDTH}
metrics_path = {d}/serve.jsonl

[Telemetry]
run_id = {run_id}

[Serving]
buckets = 1 8 64
flush_deadline_ms = 3
replicas = {a.replicas}
reload_interval_s = {a.reload_interval_s}
deadline_ms = {a.deadline_ms}
"""
        )
    return path


def _seed_checkpoint(d: str, labels, ids, vals, device: str) -> None:
    """Pre-train a few batches so the fleet has a model to load before
    the online trainer's first publish."""
    from fast_tffm_tpu_torch.config import Config
    from fast_tffm_tpu_torch.training import train

    seed_file = os.path.join(d, "seed.libsvm")
    with open(seed_file, "w") as f:
        for r in range(ids.shape[0]):
            toks = " ".join(
                f"{ids[r, c]}:{vals[r, c]:.4f}"
                for c in range(ids.shape[1])
                if vals[r, c] != 0
            )
            f.write(f"{labels[r]} {toks}\n")
    cfg = Config(
        model="fm", factor_num=K, vocabulary_size=VOCAB, max_nnz=WIDTH,
        model_file=os.path.join(d, "m.ckpt"), train_files=(seed_file,),
        epoch_num=1, batch_size=256, learning_rate=0.05, log_every=1000,
    ).validate()
    train(cfg, log=lambda *_: None, device=device)


class Writer(threading.Thread):
    """Open-loop event writer: appends ``rows`` every ``interval`` s,
    executing the stream-tier fault schedule."""

    def __init__(self, stream_path, a, stream_faults, log):
        super().__init__(name="soak-writer", daemon=True)
        from fast_tffm_tpu_torch.data.stream import StreamWriter

        self.w = StreamWriter(stream_path, width=WIDTH, vocabulary_size=VOCAB)
        self.rows = a.append_rows
        self.interval = a.append_interval_s
        self.stop = threading.Event()
        self.rng = np.random.default_rng(1234)
        self.appended_rows = 0
        self.stalls_done = 0
        self.torn_done = 0
        self.stalls_planned = [
            e["at"] for e in stream_faults if e["kind"] == "stream_stall"
        ]
        self.torn_planned = {
            e["at"] for e in stream_faults if e["kind"] == "append_torn"
        }
        self._stall_at: dict[int, int] = {}  # append ordinal -> pause s
        self.total_appends_hint = 0
        self._log = log

    def run(self):
        # Spread the planned stalls over the run's middle: stall i of S
        # fires after append ~hint·(i+1)/(S+1) — EVERY planned stall
        # executes (the final gate compares executed vs planned), with
        # none so early the loop hasn't warmed or so late the drain eats
        # it.  (The @N value is the pause LENGTH in seconds, not a
        # position — documented in resilience.STREAM_FAULT_KINDS.)
        hint = max(4, self.total_appends_hint)
        for i, pause in enumerate(self.stalls_planned):
            at = max(2, hint * (i + 1) // (len(self.stalls_planned) + 1))
            while at in self._stall_at:  # distinct ordinals
                at += 1
            self._stall_at[at] = pause
        n = 0
        while not self.stop.is_set():
            labels, ids, vals, nnz = _synth_batch(self.rng, self.rows)
            n += 1
            if n in self.torn_planned:
                # append_torn@K: flush a PARTIAL trailing record, hold it
                # torn for a couple of poll intervals, then complete it —
                # the follow reader must wait it out, never parse it.
                self._log(f"soak-writer: torn append #{n} (held 0.6s)")
                self.w.append_torn(labels, ids, vals, nnz=nnz)
                time.sleep(0.6)
                self.w.complete_torn()
                self.torn_done += 1
            else:
                self.w.append(labels, ids, vals, nnz=nnz)
            self.appended_rows += self.rows * 1
            if n in self._stall_at:
                pause = self._stall_at.pop(n)
                self._log(f"soak-writer: stream stall {pause}s (writer silent)")
                if self.stop.wait(pause):
                    break
                self.stalls_done += 1
            if self.stop.wait(self.interval):
                break
        self.w.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--smoke", action="store_true",
                    help="~30s miniature: 1 replica, trainer kill + stream "
                    "stall, every sentinel live (the tier-1 smoke)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--qps", type=float, default=250.0)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--append-rows", type=int, default=512)
    ap.add_argument("--append-interval-s", type=float, default=0.25)
    ap.add_argument("--delta-every-steps", type=int, default=20)
    ap.add_argument("--chain-max", type=int, default=12)
    ap.add_argument("--full-every-s", type=float, default=45.0)
    ap.add_argument("--reload-interval-s", type=float, default=0.25)
    ap.add_argument("--deadline-ms", type=float, default=200.0)
    ap.add_argument("--decay", type=float, default=0.999)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--stall-timeout-s", type=float, default=2.0)
    ap.add_argument("--idle-timeout-s", type=float, default=12.0)
    ap.add_argument("--freshness-p99-budget-ms", type=float, default=2000.0,
                    help="fleet publish->first-scored p99 envelope (the "
                    "PR-9 probe measured ~343ms at light load; the budget "
                    "leaves headroom for a loaded CPU box)")
    ap.add_argument("--disk-budget-mb", type=float, default=256.0)
    ap.add_argument("--fault-plan", default=None,
                    help="override the trainer+stream fault schedule "
                    "(default depends on --smoke)")
    ap.add_argument("--keep-dir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the trainer's and the fleet's --device (the card unless cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.smoke:
        args.minutes = min(args.minutes, 0.45)
        args.replicas = 1
        args.qps = 80.0
        args.append_interval_s = 0.15
        args.delta_every_steps = 8
        args.chain_max = 8
        args.full_every_s = 8.0
        args.idle_timeout_s = 8.0
        args.stall_timeout_s = 1.0
        fault_plan = args.fault_plan or "kill@40,stream_stall@2"
    else:
        fault_plan = args.fault_plan or (
            "kill@400,torn_delta@3,replica_kill@1,stream_stall@4,append_torn@5"
        )
    out_path = args.out or os.path.join(
        REPO, "PROBE_SOAK_TORCH_r16.json" if not args.smoke else "PROBE_SOAK_TORCH_smoke.json"
    )
    from fast_tffm_tpu_torch.device import resolve_device
    from fast_tffm_tpu_torch.telemetry import arm_hang_exit

    resolve_device(args.device)  # the card, or raise
    hang_timer = arm_hang_exit(max(240.0, args.minutes * 60 * 3), what="soak")

    import tempfile

    from fast_tffm_tpu_torch.checkpoint import read_delta_chain
    from fast_tffm_tpu_torch.resilience import FaultPlan
    from fast_tffm_tpu_torch.serving.client import ServeConnection, spawn_serve
    from fast_tffm_tpu_torch.telemetry import (
        RunMonitor,
        artifact_stamp,
        device_stamp,
        new_run_id,
        write_json_artifact,
    )

    plan = FaultPlan.parse(fault_plan)
    stream_faults = plan.stream_events()
    trainer_fault_spec = ",".join(
        f"{e['kind']}@{e['at']}" + (f":{e['until']}" if "until" in e else "")
        for e in plan.events
        if e["kind"] not in ("stream_stall", "append_torn", "replica_kill",
                             "replica_slow", "reload_corrupt")
    )
    replica_kills = [e for e in plan.events if e["kind"] == "replica_kill"]

    run_id = new_run_id()
    tmp_ctx = None
    if args.keep_dir:
        os.makedirs(args.keep_dir, exist_ok=True)
        d = args.keep_dir
    else:
        tmp_ctx = tempfile.TemporaryDirectory()
        d = tmp_ctx.name
    log = lambda *a_: print("soak:", *a_, flush=True)
    soak_jsonl = os.path.join(d, "soak.jsonl")
    monitor = RunMonitor(soak_jsonl, run_id=run_id, source="train")
    ticks: list[dict] = []
    t_start = time.monotonic()

    def tick_record(phase: str, checks: dict, extra: dict | None = None):
        ok = all(bool(v) for v in checks.values())
        rec = {
            "phase": phase,
            "elapsed_s": round(time.monotonic() - t_start, 1),
            "ok": ok,
            **{f"check_{k}": bool(v) for k, v in checks.items()},
            **(extra or {}),
        }
        ticks.append(rec)
        try:
            monitor.emit("soak", step=len(ticks), **rec)
        except (OSError, ValueError):
            pass  # lost soak record; the tick verdict is in `ticks` either way
        log(
            f"[{rec['elapsed_s']:7.1f}s] {phase}: "
            + ("OK" if ok else "FAIL " + str([k for k, v in checks.items() if not v]))
        )
        return ok

    serve_proc = None
    trainer = None
    writer = None
    clients: list[ServeConnection] = []
    try:
        # -- bring-up ----------------------------------------------------
        rng = np.random.default_rng(77)
        labels, ids, vals, _ = _synth_batch(rng, 1024)
        _seed_checkpoint(d, labels, ids, vals, args.device)
        log("seed checkpoint written")

        stream_path = os.path.join(d, "stream.fms")
        writer = Writer(stream_path, args, stream_faults, log)
        total_s = args.minutes * 60.0
        writer.total_appends_hint = max(4, int(total_s / args.append_interval_s))
        # Warm prefix so the trainer has data the moment it starts.
        for _ in range(3):
            lb, id_, vl, nz = _synth_batch(writer.rng, args.append_rows)
            writer.w.append(lb, id_, vl, nnz=nz)
            writer.appended_rows += args.append_rows
        writer.start()

        tcfg = _train_cfg(d, run_id, args)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        tcmd = [
            sys.executable, "-m", "fast_tffm_tpu_torch.cli", "train", tcfg,
            "--supervised", "--resume", "--device", args.device,
        ]
        if trainer_fault_spec:
            tcmd += ["--fault-plan", trainer_fault_spec]
        trainer_log = open(os.path.join(d, "trainer.log"), "w")
        trainer = subprocess.Popen(
            tcmd, stdout=trainer_log, stderr=subprocess.STDOUT, env=env, cwd=REPO
        )
        log(f"trainer (supervised) pid {trainer.pid}: {' '.join(tcmd[3:])}")

        scfg = _serve_cfg(d, run_id, args)
        serve_proc, port = spawn_serve(scfg, port=0, timeout_s=600.0, device=args.device)
        log(f"serving fleet up on port {port} ({args.replicas} replica(s))")
        control = ServeConnection(port)
        clients.append(control)

        # -- load client (open loop) ------------------------------------
        sent = [0]
        answered = [0]
        codes: dict[str, int] = {}
        lat: list[float] = []
        lat_lock = threading.Lock()

        def on_response(msg, meta):
            answered[0] += 1
            if meta is not None:
                with lat_lock:
                    lat.append(time.perf_counter() - meta)
            if "score" not in msg:
                code = str(msg.get("code") or "error")
                with lat_lock:
                    codes[code] = codes.get(code, 0) + 1
            return True

        data = ServeConnection(port, on_response=on_response)
        # The window (--minutes, the sentinel ticks, the replica-kill
        # schedule) starts once the fleet is up; see the module docstring.
        t_start = time.monotonic()
        clients.append(data)
        stop_load = threading.Event()

        def load_loop():
            lrng = np.random.default_rng(9)
            lines = _score_lines(lrng, 2048)
            interval = 1.0 / args.qps
            t_next = time.perf_counter()
            i = 0
            while not stop_load.is_set():
                now = time.perf_counter()
                if now < t_next:
                    time.sleep(min(t_next - now, 0.05))
                    continue
                t_next += interval
                try:
                    data.send({"line": lines[i % len(lines)]}, meta=now)
                    sent[0] += 1
                except OSError:
                    break
                i += 1

        load_thread = threading.Thread(target=load_loop, name="soak-load", daemon=True)
        load_thread.start()

        # -- replica-kill schedule (full mode) ---------------------------
        kill_at = []
        if replica_kills and args.replicas > 1:
            for j, e in enumerate(replica_kills):
                kill_at.append(
                    (t_start + total_s * (0.35 + 0.3 * j), int(e["at"]) % args.replicas)
                )

        # -- sentinel loop ----------------------------------------------
        tick_s = 5.0 if args.smoke else 15.0
        end_t = t_start + total_s
        failures = 0
        max_chain = 0
        max_disk = 0
        chain_read_errors = 0
        chain_errors_streak = 0
        while time.monotonic() < end_t:
            time.sleep(tick_s)
            for when, victim in list(kill_at):
                if time.monotonic() >= when:
                    kill_at.remove((when, victim))
                    try:
                        stats0 = control.request({"op": "stats"}, timeout=30)
                        pid = next(
                            (
                                r["pid"]
                                for r in stats0.get("replicas", [])
                                if r.get("replica") == victim and r.get("pid")
                            ),
                            None,
                        )
                        if pid is None:
                            pid = (
                                stats0.get("engines", {})
                                .get(str(victim), {})
                                .get("pid")
                            )
                        if pid:
                            log(f"CHAOS: SIGKILL replica {victim} (pid {pid})")
                            os.kill(int(pid), signal.SIGKILL)
                    except Exception as e:
                        log(f"replica kill failed: {e!r}")
            try:
                stats = control.request({"op": "stats"}, timeout=30)
            except Exception as e:
                stats = {"error": repr(e)}
            # Chain + disk bounds (the compaction invariant).
            model_file = os.path.join(d, "m.ckpt")
            try:
                _, chain = read_delta_chain(model_file)
                chain_len = len(chain)
                chain_errors_streak = 0
            except Exception:
                # A torn delta (the injected fault) legitimately breaks the
                # chain READ until the next full save heals it (promote/
                # unlink) or the supervisor's repair quarantines the tail —
                # a transient, not a sentinel failure.  Persisting across
                # consecutive ticks IS one: compaction stopped working.
                chain_len = None
                chain_read_errors += 1
                chain_errors_streak += 1
            disk = 0
            for fn in os.listdir(d):
                if fn.startswith("m.ckpt"):
                    try:
                        disk += os.path.getsize(os.path.join(d, fn))
                    except OSError:
                        pass
            if chain_len is not None:
                max_chain = max(max_chain, chain_len)
            max_disk = max(max_disk, disk)
            scored_p99 = (stats.get("freshness") or {}).get(
                "scored_p99_ms_worst_replica"
            )
            staged = ((stats.get("freshness") or {}).get("staged_ms") or {})
            steady = [
                (e.get("steady_compiles"))
                for e in (stats.get("engines") or {}).values()
                if isinstance(e, dict) and "steady_compiles" in e
            ]
            unanswered_now = sent[0] - answered[0]
            checks = {
                "trainer_alive": trainer.poll() is None,
                "serving_alive": serve_proc.poll() is None,
                # In-flight backlog bounded: everything but the last few
                # seconds' sends must be answered (typed errors count —
                # unanswered means NO response line at all).
                "no_unanswered_backlog": unanswered_now <= max(64, args.qps * 3),
                "chain_bounded": (
                    chain_errors_streak < 3
                    if chain_len is None
                    else 0 <= chain_len <= args.chain_max
                ),
                "disk_bounded": disk <= args.disk_budget_mb * (1 << 20),
                "replicas_no_steady_recompiles": all((x or 0) == 0 for x in steady),
                "freshness_within_budget": (
                    scored_p99 is None
                    or scored_p99 <= args.freshness_p99_budget_ms
                ),
            }
            ok = tick_record(
                "steady",
                checks,
                {
                    "sent": sent[0],
                    "answered": answered[0],
                    "unanswered_now": unanswered_now,
                    "chain_len": chain_len,
                    "disk_bytes": disk,
                    "freshness_scored_p99_ms": scored_p99,
                    "freshness_staged_p99_ms": staged.get("p99"),
                    "reload_fanouts": stats.get("reload_fanouts"),
                    "failovers": stats.get("failovers"),
                    "appended_rows": writer.appended_rows,
                },
            )
            failures += 0 if ok else 1

        # -- drain -------------------------------------------------------
        stop_load.set()
        load_thread.join(timeout=10)
        writer.stop.set()
        writer.join(timeout=15)
        left = data.drain_inflight(timeout=30.0)
        unanswered = left  # no response line AT ALL after the drain window
        # Trainer: the writer stopped, so the follow stream idles out and
        # the trainer exits cleanly (final sync save) via its supervisor.
        trainer_rc = None
        try:
            trainer_rc = trainer.wait(timeout=args.idle_timeout_s * 3 + 60)
        except subprocess.TimeoutExpired:
            trainer.terminate()
        final_stats = {}
        try:
            final_stats = control.request({"op": "stats"}, timeout=30)
        except Exception as e:
            log(f"final stats poll failed (fleet already torn down?): {e!r}")

        # Trainer-side telemetry digest (restarts, stalls, ckpt counters,
        # steady compiles) from its JSONL.
        t_restarts = t_stream_idle_stalls = t_steady_compiles = 0
        t_ckpt = {}
        try:
            for line in open(os.path.join(d, "trainer.jsonl")):
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                k = r.get("kind")
                if k == "restart":
                    t_restarts += 1
                elif k == "stall" and "stream-idle" in str(r.get("classification")):
                    t_stream_idle_stalls += 1
                elif k == "compile" and not r.get("warmup"):
                    t_steady_compiles += r.get("compiles") or 0
                elif k == "summary":
                    t_ckpt = {
                        key: r[key]
                        for key in r
                        if key.startswith("ckpt_") or key.startswith("fault_")
                    }
        except OSError:
            pass

        planned_kills = sum(1 for e in plan.events if e["kind"] == "kill")
        gates = {
            "zero_unanswered": unanswered == 0,
            "all_sentinel_ticks_ok": failures == 0,
            "trainer_finished_cleanly": trainer_rc == 0,
            "trainer_restart_observed": t_restarts >= min(1, planned_kills),
            "trainer_zero_steady_recompiles": t_steady_compiles == 0,
            "chain_bounded_throughout": 0 <= max_chain <= args.chain_max,
            "disk_bounded_throughout": max_disk <= args.disk_budget_mb * (1 << 20),
            # The planned stream faults ACTUALLY executed (a schedule
            # that silently half-ran would report coverage it never had).
            "stream_faults_executed": (
                writer.stalls_done >= len(writer.stalls_planned)
                and writer.torn_done >= len(writer.torn_planned)
            ),
        }
        ok = tick_record(
            "final",
            gates,
            {
                "sent": sent[0],
                "answered": answered[0],
                "unanswered": unanswered,
                "trainer_rc": trainer_rc,
                "trainer_restarts": t_restarts,
                "stream_idle_stalls": t_stream_idle_stalls,
            },
        )

        with lat_lock:
            lats = sorted(lat)
        pct = lambda q: (
            round(lats[min(len(lats) - 1, int(q * len(lats)))] * 1e3, 2)
            if lats
            else None
        )
        result = {
            **artifact_stamp(run_id),
            **device_stamp(args.device),
            "tool": "soak",
            "mode": "smoke" if args.smoke else "full",
            "duration_s": round(time.monotonic() - t_start, 1),
            "replicas": args.replicas,
            "qps_offered": args.qps,
            "fault_plan": plan.to_json(),
            "requests_sent": sent[0],
            "requests_answered": answered[0],
            "unanswered": unanswered,
            "typed_codes": codes,
            "client_latency_ms": {"p50": pct(0.5), "p99": pct(0.99)},
            "appended_rows": writer.appended_rows,
            "stream_stalls_executed": writer.stalls_done,
            "torn_appends_executed": writer.torn_done,
            "trainer_rc": trainer_rc,
            "trainer_restarts": t_restarts,
            "trainer_stream_idle_stalls": t_stream_idle_stalls,
            "trainer_steady_compiles": t_steady_compiles,
            "trainer_ckpt": t_ckpt,
            "max_chain_len": max_chain,
            "max_disk_bytes": max_disk,
            "chain_read_errors": chain_read_errors,
            "freshness_final": (final_stats.get("freshness") or {}),
            "router_failovers": final_stats.get("failovers"),
            "router_reload_fanouts": final_stats.get("reload_fanouts"),
            "sentinel_ticks": len(ticks),
            "sentinel_failures": failures + (0 if ok else 1),
            "gates": gates,
            "gate": "OK" if ok and failures == 0 else "REGRESSED",
            "ticks": ticks[-50:],
        }
        write_json_artifact(out_path, result, sort_keys=False)
        log(f"wrote {out_path} (gate: {result['gate']})")
        return 0 if result["gate"] == "OK" else 1
    finally:
        hang_timer.cancel()
        for c in clients:
            c.close()
        if serve_proc is not None and serve_proc.poll() is None:
            serve_proc.terminate()
            try:
                serve_proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                serve_proc.kill()
        if trainer is not None and trainer.poll() is None:
            trainer.terminate()
            try:
                trainer.wait(timeout=20)
            except subprocess.TimeoutExpired:
                trainer.kill()
        if writer is not None:
            writer.stop.set()
        monitor.close()
        if tmp_ctx is not None:
            tmp_ctx.cleanup()


if __name__ == "__main__":
    raise SystemExit(main())
