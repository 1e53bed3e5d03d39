#!/usr/bin/env python
"""Serving load generator of the PyTorch/CUDA port: drive an engine or a
socket front end of ``fast_tffm_tpu_torch``, emit BENCH_SERVE JSON — the
counterpart of ``tools/loadgen.py``, with its keys.

One JSON object: client-observed latency percentiles (p50/p95/p99, overall
AND per client class), achieved QPS, typed-shed counts (overloaded /
deadline / unavailable), the engine's own queue/compute/occupancy metrics,
the compile counts that pin "zero steady-state recompiles" (the port's
compiles: kernel builds and CUDA-graph captures), the card (``nvidia-smi``
name and power limit) and the torch and CUDA versions.

Two transports:

  * **in-process** (default) — a ServingEngine in this process on
    ``--device`` (the card unless ``--device cpu``; without a card it
    raises); measures the engine alone, no network.
  * **socket** (``--connect HOST:PORT`` or ``--spawn``) — speak the wire
    protocol (serving/protocol.py) to a live front end; ``--spawn``
    launches ``python -m fast_tffm_tpu_torch.cli serve <cfg> --port 0
    [--device D]`` and tears it down after.  ``--connections N``
    pipelined TCP connections each run an independent open-loop schedule
    at qps/N; ``--processes N`` fans the schedule across N sender
    processes (one Python sender tops out near ~25k offered requests/s).

Two modes:

  * ``open`` (default) — open-loop Poisson arrivals at ``--qps``: the
    generator submits on a fixed random schedule whether or not earlier
    requests finished, which is what exposes queueing collapse.  In process
    it forces ``serve_overload = reject`` (a blocking submit would stall
    the schedule).
  * ``closed`` — ``--concurrency`` workers each submit-and-wait in a
    loop: best-case service latency and saturation throughput.

Traffic shaping: ``--classes gold:0.1,std:0.9`` draws each request's
client class; ``--deadline-ms`` stamps a per-request deadline.  Request
sizes are mixed (per-line nnz drawn 1..max_nnz) so every ladder bucket
runs.  ``--stats`` polls a live tier's ``stats`` op once;
``--probe-freshness N`` publishes N checkpoints (the port's writer) and
times publish → first scored with the new rows through the wire.

Usage:
    python tools/torch_loadgen.py run.cfg --mode open --qps 500 --duration 3
    python tools/torch_loadgen.py run.cfg --spawn --connections 8 --qps 10000 \
        --classes gold:0.1,std:0.9 --deadline-ms 50 --out BENCH_SERVE.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fast_tffm_tpu_torch.serving.client import (
    FrameConnection,
    ServeConnection,
    WireRefused,
    spawn_serve,
)
from fast_tffm_tpu_torch.serving.protocol import FRAME_HEADER, exc_code, pack_request_frame


def synth_lines(cfg, n: int, max_nnz: int, seed: int) -> list[str]:
    """Random libsvm lines over the configured vocab, nnz mixed 1..max_nnz
    so the bucket ladder (and its padding) sees every width."""
    rng = np.random.default_rng(seed)
    v = min(cfg.vocabulary_size, 1 << 20)
    lines = []
    for _ in range(n):
        # Clamp to the vocab: choice(replace=False) can't draw k > v.
        k = int(rng.integers(1, min(max_nnz, v) + 1))
        ids = rng.choice(v, size=k, replace=False)
        vals = np.round(np.abs(rng.normal(size=k)) + 0.1, 4)
        toks = " ".join(f"{i}:{x}" for i, x in zip(ids, vals))
        lines.append(f"{int(rng.integers(0, 2))} {toks}")
    return lines


def parse_class_mix(spec: str) -> list[tuple[str, float]]:
    """``gold:0.1,std:0.9`` → [(name, fraction)]; fractions normalized."""
    out = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, sep, frac = tok.partition(":")
        if not sep or not name:
            raise ValueError(f"--classes entries are name:fraction, got {tok!r}")
        out.append((name, float(frac)))
    total = sum(f for _, f in out)
    if not out or total <= 0:
        raise ValueError(f"--classes needs positive fractions, got {spec!r}")
    return [(n, f / total) for n, f in out]


def draw_class(rng, mix: list[tuple[str, float]] | None) -> str:
    if not mix:
        return ""
    x = rng.random()
    acc = 0.0
    for name, frac in mix:
        acc += frac
        if x < acc:
            return name
    return mix[-1][0]


# ---------------------------------------------------------------------------
# result aggregation (shared by both transports)
# ---------------------------------------------------------------------------


class Results:
    """Thread-safe (klass, latency | typed code) sink."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lat: list[float] = []
        self.lat_by_class: dict[str, list[float]] = {}
        self.codes: dict[str, int] = {}
        self.sent = 0

    def on_sent(self, n=1):
        with self._lock:
            self.sent += n

    def ok(self, klass: str, latency_s: float):
        with self._lock:
            self.lat.append(latency_s)
            self.lat_by_class.setdefault(klass or "default", []).append(latency_s)

    def err(self, code: str):
        with self._lock:
            self.codes[code] = self.codes.get(code, 0) + 1


def percentiles_ms(lat: list[float]) -> dict:
    if not lat:
        return {"count": 0}
    a = np.asarray(lat) * 1e3
    return {
        "count": int(a.size),
        "mean": round(float(a.mean()), 3),
        "p50": round(float(np.percentile(a, 50)), 3),
        "p95": round(float(np.percentile(a, 95)), 3),
        "p99": round(float(np.percentile(a, 99)), 3),
        "max": round(float(a.max()), 3),
    }


# ---------------------------------------------------------------------------
# in-process transport (class and deadline aware)
# ---------------------------------------------------------------------------


def run_open_engine(engine, lines, args, mix, res: Results):
    rng = np.random.default_rng(args.seed)
    t_end = time.perf_counter() + args.duration
    i = 0
    t_next = time.perf_counter()
    while time.perf_counter() < t_end and res.sent < args.requests:
        now = time.perf_counter()
        if now < t_next:
            time.sleep(min(t_next - now, 0.005))
            continue
        t_next += rng.exponential(1.0 / args.qps)
        klass = draw_class(rng, mix)
        t0 = time.perf_counter()
        try:
            fut = engine.submit_line(
                lines[i % len(lines)], klass=klass,
                deadline_ms=args.deadline_ms or None,
            )
        except Exception as e:
            res.err(exc_code(e))
            res.on_sent()
            i += 1
            continue

        def _record(f, t0=t0, klass=klass):
            exc = f.exception()
            if exc is None:
                res.ok(klass, time.perf_counter() - t0)
            else:
                res.err(exc_code(exc))

        fut.add_done_callback(_record)
        res.on_sent()
        i += 1
    # Drain: wait for stragglers to resolve (callbacks fill res).
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with res._lock:
            done = len(res.lat) + sum(res.codes.values())
        if done >= res.sent:
            break
        time.sleep(0.01)


def run_closed_engine(engine, lines, args, mix, res: Results):
    stop = time.perf_counter() + args.duration
    lock = threading.Lock()
    counter = [0]

    def worker(wid: int):
        rng = np.random.default_rng(args.seed + wid)
        i = wid
        while time.perf_counter() < stop:
            with lock:
                if counter[0] >= args.requests:
                    return
                counter[0] += 1
            klass = draw_class(rng, mix)
            t0 = time.perf_counter()
            try:
                engine.submit_line(
                    lines[i % len(lines)], klass=klass,
                    deadline_ms=args.deadline_ms or None,
                ).result(timeout=30)
            except Exception as e:
                res.err(exc_code(e))
                res.on_sent()
                i += args.concurrency
                time.sleep(0.001)
                continue
            res.ok(klass, time.perf_counter() - t0)
            res.on_sent()
            i += args.concurrency

    threads = [
        # daemon: a SIGINT mid-run must be able to exit without joining
        # every worker (the open sockets die with the process)
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(args.concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


# ---------------------------------------------------------------------------
# socket transport (shared pipelined client: serving/client.py)
# ---------------------------------------------------------------------------


def bench_connection(port: int, host: str, res: Results) -> ServeConnection:
    """A ServeConnection routing score responses into the Results sink
    (meta = (t_send, klass)); op acks flow through request() as usual."""

    def on_response(msg, meta):
        if meta is None:
            return False  # not ours to consume
        t0, klass = meta
        if "score" in msg:
            res.ok(klass, time.perf_counter() - t0)
        else:
            res.err(msg.get("code", "unavailable"))
        return True

    return ServeConnection(port, host=host, on_response=on_response)


def send_score(conn: ServeConnection, res, line, klass, deadline_ms) -> None:
    msg = {"line": line}
    if klass:
        msg["class"] = klass
    if deadline_ms:
        msg["deadline_ms"] = deadline_ms
    conn.send(msg, meta=(time.perf_counter(), klass))
    res.on_sent()


def run_open_socket(conns: list[ServeConnection], lines, args, mix, res: Results):
    """Each connection runs an independent Poisson schedule at qps/C —
    open-loop in aggregate, parallel enough to drive 10k+ QPS from one
    Python client."""
    per_conn_qps = args.qps / len(conns)
    t_end = time.perf_counter() + args.duration
    cap = max(1, args.requests // len(conns))

    def sender(ci: int, conn: ServeConnection):
        rng = np.random.default_rng(args.seed + ci)
        i = ci
        sent = 0
        t_next = time.perf_counter()
        while time.perf_counter() < t_end and sent < cap:
            now = time.perf_counter()
            if now < t_next:
                time.sleep(min(t_next - now, 0.002))
                continue
            t_next += rng.exponential(1.0 / per_conn_qps)
            try:
                send_score(
                    conn, res, lines[i % len(lines)], draw_class(rng, mix),
                    args.deadline_ms or None,
                )
            except OSError:
                res.err("unavailable")
            sent += 1
            i += len(conns)

    threads = [
        # daemon: abandonable on SIGINT, same as the worker pools
        threading.Thread(target=sender, args=(ci, c), daemon=True)
        for ci, c in enumerate(conns)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(c.inflight() for c in conns):
        time.sleep(0.01)


def build_frame_pool(lines, cfg, mix, rows, seed, uses_fields, deadline_ms,
                     n_templates: int = 256):
    """Pre-packed REQUEST frame templates (req_ids zeroed — the sender
    patches a fresh range in per send, one bytes-concat).  Packing lives
    HERE, outside the timed loop, so the measured client cost per frame
    is one concat + one sendall.  One class per template (drawn from the
    mix) so server-side per-class latency attribution stays exact."""
    from fast_tffm_tpu_torch.data.libsvm import parse_lines

    pb = parse_lines(
        lines,
        vocabulary_size=cfg.vocabulary_size,
        hash_feature_id_flag=cfg.hash_feature_id,
        max_nnz=cfg.max_nnz if cfg.max_nnz > 0 else None,
    )
    rng = np.random.default_rng(seed)
    dl = np.full(rows, deadline_ms, np.float32) if deadline_ms else None
    pool = []
    for _ in range(n_templates):
        klass = draw_class(rng, mix)
        sel = rng.integers(0, pb.batch_size, size=rows)
        data = pack_request_frame(
            np.zeros(rows, np.uint32),
            pb.ids[sel],
            pb.vals[sel],
            fields=pb.fields[sel] if uses_fields else None,
            deadlines_ms=dl,
            classes=[klass] * rows if klass else None,
        )
        pool.append((data, rows, klass))
    return pool


def _frame_cb(meta: dict, res: Results):
    """Per-connection on_result sink: meta maps req_id -> (t_send, klass);
    runs on the connection's reader thread."""

    def cb(rid, status, score):
        m = meta.pop(rid, None)
        if m is None:
            return
        t0, klass = m
        if status == "ok":
            res.ok(klass, time.perf_counter() - t0)
        else:
            res.err(status)

    return cb


def run_open_frames(conns, metas, pool, rows, args, res: Results):
    """Open-loop over the binary wire: each pinned connection runs an
    independent Poisson schedule of FRAMES at (qps/C)/rows — offered load
    is still counted in requests (rows), so QPS math matches the JSONL
    path."""
    hdr = FRAME_HEADER.size
    per_conn_fps = args.qps / len(conns) / rows
    t_end = time.perf_counter() + args.duration
    cap_frames = max(1, args.requests // (len(conns) * rows))

    def sender(ci: int, conn: FrameConnection, meta: dict):
        rng = np.random.default_rng(args.seed + ci)
        rid = 1
        ti = ci
        sent = 0
        t_next = time.perf_counter()
        while time.perf_counter() < t_end and sent < cap_frames:
            now = time.perf_counter()
            if now < t_next:
                time.sleep(min(t_next - now, 0.002))
                continue
            t_next += rng.exponential(1.0 / per_conn_fps)
            data, n, klass = pool[ti % len(pool)]
            rids = np.arange(rid, rid + n, dtype=np.uint32)
            buf = data[:hdr] + rids.tobytes() + data[hdr + 4 * n:]
            t0 = time.perf_counter()
            for r in range(rid, rid + n):
                meta[r] = (t0, klass)
            try:
                conn.send_packed(buf, rids)
            except OSError:
                for r in range(rid, rid + n):
                    meta.pop(r, None)
                    res.err("unavailable")
            res.on_sent(n)
            rid += n
            sent += 1
            ti += len(conns)

    threads = [
        # daemon: abandonable on SIGINT, same as the JSONL sender pool
        threading.Thread(target=sender, args=(ci, c, m), daemon=True)
        for ci, (c, m) in enumerate(zip(conns, metas))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and any(c.inflight() for c in conns):
        time.sleep(0.01)


def drive_open(host, port, lines, cfg, args, mix, res: Results, sync=None) -> dict:
    """One process's open-loop drive: negotiate the wire (binary unless
    refused or --wire jsonl), run the schedule, drain.  ``sync`` (worker
    mode) is called after all pre-pack/connect setup and right before
    the timed loop — the multi-process start barrier.  Returns the
    transport facts + measured wall."""
    wire = args.wire
    conns: list[FrameConnection] = []
    metas: list[dict] = []
    if wire == "binary":
        try:
            for _ in range(args.connections):
                meta: dict = {}
                conns.append(
                    FrameConnection(port, host=host, on_result=_frame_cb(meta, res))
                )
                metas.append(meta)
        except WireRefused as e:
            for c in conns:
                c.close()
            conns, metas = [], []
            wire = "jsonl"
            print(f"loadgen: {e}; falling back to JSONL", file=sys.stderr)
    if wire == "binary":
        try:
            rows = max(1, min(args.frame_rows, min(c.max_frame_rows for c in conns)))
            pool = build_frame_pool(
                lines, cfg, mix, rows, args.seed, conns[0].uses_fields,
                args.deadline_ms,
            )
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            run_open_frames(conns, metas, pool, rows, args, res)
            wall = time.perf_counter() - t0
            return {
                "wire": "binary",
                "frame_rows": rows,
                "client_failovers": sum(c.failovers for c in conns),
                "unanswered": sum(c.inflight() for c in conns),
                "wall": wall,
            }
        finally:
            for c in conns:
                c.close()
    jconns = [bench_connection(port, host, res) for _ in range(args.connections)]
    try:
        if sync is not None:
            sync()
        t0 = time.perf_counter()
        run_open_socket(jconns, lines, args, mix, res)
        wall = time.perf_counter() - t0
        return {
            "wire": "jsonl",
            "unanswered": sum(c.inflight() for c in jconns),
            "wall": wall,
        }
    finally:
        for c in jconns:
            c.close()


def run_worker(args, cfg, lines, mix) -> int:
    """Hidden --worker mode for --processes: drive qps/N against a LIVE
    front end, then print ONE JSON line of raw results (per-class
    latency lists in seconds) for the parent to merge.  Start barrier:
    prints WORKER_READY after setup, blocks on a stdin line."""
    host, _, port = args.connect.rpartition(":")
    host, port = host or "127.0.0.1", int(port)
    res = Results()

    def sync():
        print("WORKER_READY", flush=True)
        sys.stdin.readline()

    extra = drive_open(host, port, lines, cfg, args, mix, res, sync=sync)
    with res._lock:
        out = {
            "sent": res.sent,
            "codes": res.codes,
            "lat": {k: [round(x, 6) for x in v]
                    for k, v in res.lat_by_class.items()},
            **extra,
        }
    print(json.dumps(out, separators=(",", ":")))
    return 0


def run_multiprocess(args, host, port, res: Results) -> dict:
    """Fan the open-loop schedule across N worker PROCESSES (qps/N each)
    — one Python process tops out near ~25k offered QPS on send-side
    CPU alone; 50k+ needs real parallelism, which the GIL won't give
    threads.  Workers pre-pack, barrier on WORKER_READY/GO, then drive;
    the parent merges raw per-class latencies so percentiles are
    computed over the UNION, not averaged."""
    n = args.processes
    cmd_base = [
        sys.executable, os.path.abspath(__file__), args.config,
        "--worker", "--connect", f"{host}:{port}",
        "--mode", "open",
        "--qps", str(args.qps / n),
        "--duration", str(args.duration),
        "--connections", str(args.connections),
        "--wire", args.wire,
        "--frame-rows", str(args.frame_rows),
        "--deadline-ms", str(args.deadline_ms),
        "--requests", str(max(1, args.requests // n)),
    ]
    if args.classes:
        cmd_base += ["--classes", args.classes]
    if args.input:
        cmd_base += ["--input", args.input]
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            cmd_base + ["--seed", str(args.seed + 1000 * k)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        )
        for k in range(n)
    ]
    try:
        for p in procs:  # barrier: every worker finished pre-packing
            line = p.stdout.readline()
            if not line.startswith("WORKER_READY"):
                raise RuntimeError(f"worker died during setup: {line!r}")
        for p in procs:  # fire together
            p.stdin.write("GO\n")
            p.stdin.flush()
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=args.duration + 300)
            if p.returncode != 0:
                raise RuntimeError(f"worker exited rc={p.returncode}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for o in outs:
        res.sent += o["sent"]
        for code, c in o["codes"].items():
            res.codes[code] = res.codes.get(code, 0) + c
        for klass, lat in o["lat"].items():
            res.lat.extend(lat)
            res.lat_by_class.setdefault(klass, []).extend(lat)
    return {
        "processes": n,
        "wire": outs[0].get("wire"),
        "frame_rows": outs[0].get("frame_rows"),
        "client_failovers": sum(o.get("client_failovers", 0) for o in outs),
        "unanswered": sum(o["unanswered"] for o in outs),
        "wall": max(o["wall"] for o in outs),
    }


def run_closed_socket(port, host, lines, args, mix, res: Results):
    stop = time.perf_counter() + args.duration
    lock = threading.Lock()
    counter = [0]

    def worker(wid: int):
        conn = ServeConnection(port, host=host)
        rng = np.random.default_rng(args.seed + wid)
        i = wid
        try:
            while time.perf_counter() < stop:
                with lock:
                    if counter[0] >= args.requests:
                        return
                    counter[0] += 1
                klass = draw_class(rng, mix)
                t0 = time.perf_counter()
                try:
                    msg = conn.request(
                        {
                            "line": lines[i % len(lines)],
                            **({"class": klass} if klass else {}),
                            **(
                                {"deadline_ms": args.deadline_ms}
                                if args.deadline_ms
                                else {}
                            ),
                        },
                        timeout=30,
                    )
                except (TimeoutError, OSError):
                    res.err("unavailable")
                    res.on_sent()
                    i += args.concurrency
                    continue
                res.on_sent()
                if "score" in msg:
                    res.ok(klass, time.perf_counter() - t0)
                else:
                    res.err(msg.get("code", "unavailable"))
                i += args.concurrency
        finally:
            conn.close()

    threads = [
        # daemon: a SIGINT mid-run must be able to exit without joining
        # every worker (the open sockets die with the process)
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(args.concurrency)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def fresh_state(cfg, model, seed: int):
    """A fresh random state on the host from a seeded generator (a packed
    config's checkpoint holds the logical arrays: its fused accumulator is
    a row one)."""
    import torch

    from fast_tffm_tpu_torch.trainer import init_state

    accumulator = "row" if cfg.adagrad_accumulator == "fused" else cfg.adagrad_accumulator
    return init_state(model, torch.Generator().manual_seed(seed), cfg.init_accumulator_value,
                      accumulator)


def run_freshness_probe(args, cfg, log) -> int:
    """Tagged-probe freshness SLO, measured BLACK-BOX through the socket
    front end: per trial, score a sentinel id, atomically
    publish a checkpoint whose sentinel row changed, then poll the
    sentinel through the wire until its score flips.  flip-time − publish
    -time IS publish→first-scored-with-new-rows as a client experiences
    it — router reload poll, restore, collector swap, and micro-batch
    flush all included.  The server-side kind=freshness records (engine +
    router) measure the same pipe white-box; the probe JSON carries both,
    stamped with the tier's run_id so it joins the telemetry streams."""
    from fast_tffm_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
    from fast_tffm_tpu_torch.config import build_model
    from fast_tffm_tpu_torch.telemetry import artifact_stamp, device_stamp, write_json_artifact

    if cfg.serve_reload_interval_s <= 0:
        print(
            "probe-freshness: [Serving] reload_interval_s must be > 0 "
            "(the router's checkpoint watcher drives the reload fan-out)",
            file=sys.stderr,
        )
        return 2
    import torch

    model = build_model(cfg)
    # The publisher's state lives on the host: the probe only writes it.
    if os.path.exists(cfg.model_file.rstrip("/")):
        width = 1 if cfg.adagrad_accumulator in ("row", "fused") else model.row_dim
        state = restore_checkpoint(cfg.model_file, torch.device("cpu"),
                                   n_dense=len(model.dense_names), accum_width=width)
    else:
        state = fresh_state(cfg, model, args.seed)
        save_checkpoint(cfg.model_file, state)
        log(f"probe-freshness: wrote fresh checkpoint {cfg.model_file}")
    sentinel = 1  # any in-vocab id works; the probe only needs its row
    line = f"0 {sentinel}:1.0"
    proc, port = spawn_serve(args.config, log=log, device=args.device)
    conn = ServeConnection(port)
    flips_ms: list[float] = []
    unanswered = 0
    try:
        for trial in range(args.probe_freshness):
            s0 = float(conn.request({"line": line}, timeout=30)["score"])
            # Perturb the sentinel row (bias + factors) and publish — the
            # atomic tmp+rename the trainer's saves use, so the tier sees
            # exactly a production publish.
            state.table[sentinel] += 0.25
            state.step += 1
            save_checkpoint(cfg.model_file, state)
            t_pub = time.time()
            deadline = t_pub + 30.0
            flipped = None
            while time.time() < deadline:
                s1 = float(conn.request({"line": line}, timeout=30)["score"])
                if abs(s1 - s0) > 1e-9:
                    flipped = (time.time() - t_pub) * 1e3
                    break
                time.sleep(0.002)
            if flipped is None:
                unanswered += 1
                log(f"probe-freshness: trial {trial} never flipped (30s)")
            else:
                flips_ms.append(flipped)
                log(f"probe-freshness: trial {trial} flipped in {flipped:.1f} ms")
        stats = conn.request({"op": "stats"}, timeout=60)
    finally:
        conn.close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
    engines = stats.get("engines", {})
    steady = [
        e.get("steady_compiles")
        for e in engines.values()
        if isinstance(e.get("steady_compiles"), int)
    ]
    result = {
        "probe": "PROBE_FRESHNESS",
        **artifact_stamp(stats.get("run_id", "")),
        **device_stamp(args.device or "cuda"),
        "trials": args.probe_freshness,
        "unanswered": unanswered,
        "replicas": cfg.serve_replicas,
        "reload_interval_s": cfg.serve_reload_interval_s,
        "publish_to_first_scored_ms": percentiles_ms([x / 1e3 for x in flips_ms]),
        "engine_freshness_scored_ms": {
            k: (e.get("engine") or {}).get("freshness_scored_ms")
            for k, e in sorted(engines.items())
        },
        "engine_freshness_applied_ms": {
            k: (e.get("engine") or {}).get("freshness_applied_ms")
            for k, e in sorted(engines.items())
        },
        "fleet_freshness": stats.get("freshness"),
        "steady_state_recompiles": max(steady) if steady else None,
        "note": (
            "black-box SLO: sentinel scored through the 2-connection wire; "
            "flip latency includes router reload poll + restore + swap + "
            "flush.  engine_* histograms are the white-box twin measured "
            "against the checkpoint's embedded publish stamp."
        ),
    }
    out = json.dumps(result, indent=2)
    print(out)
    if args.out:
        write_json_artifact(args.out, result, indent=2, sort_keys=False)
    return 0 if flips_ms and not unanswered else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", help="INI config (uses [Serving] + model_file)")
    ap.add_argument("--mode", choices=("open", "closed"), default="open")
    ap.add_argument("--qps", type=float, default=500.0, help="open-loop arrival rate")
    ap.add_argument("--concurrency", type=int, default=8, help="closed-loop workers")
    ap.add_argument("--duration", type=float, default=3.0, help="seconds of traffic")
    ap.add_argument("--requests", type=int, default=10**9, help="request cap")
    ap.add_argument("--input", default=None, help="libsvm file of request lines")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument(
        "--connect", default=None, metavar="HOST:PORT",
        help="drive a LIVE socket front end instead of an in-process engine",
    )
    ap.add_argument(
        "--spawn", action="store_true",
        help="spawn `serve <cfg> --port 0` (replicated front end) and drive it",
    )
    ap.add_argument(
        "--connections", type=int, default=4, metavar="C",
        help="socket open-loop: parallel pipelined connections, each at qps/C "
        "(the multi-connection sender that makes 10k+ QPS drivable)",
    )
    ap.add_argument(
        "--wire", choices=("binary", "jsonl"), default="binary",
        help="DATA wire for the socket open loop: binary frames pinned to "
        "a replica (negotiated — falls back to JSONL when the server "
        "refuses), or force the per-line JSONL path",
    )
    ap.add_argument(
        "--frame-rows", type=int, default=32, metavar="R",
        help="rows coalesced per binary REQUEST frame (clamped to the "
        "replica's negotiated max_frame_rows)",
    )
    ap.add_argument(
        "--processes", type=int, default=1, metavar="N",
        help="open-loop socket mode: fan the schedule across N worker "
        "processes at qps/N each (one Python sender tops out ~25k offered; "
        "50k+ needs processes, not threads)",
    )
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument(
        "--device", default=None, metavar="D",
        help="where the engine scores: cuda (default; raises without a card) or cpu; "
        "passed to the spawned front end as `serve --device D`",
    )
    ap.add_argument(
        "--classes", default=None, metavar="MIX",
        help="client-class traffic mix, e.g. gold:0.1,std:0.9 (tiers come "
        "from the server's serve_classes)",
    )
    ap.add_argument(
        "--deadline-ms", type=float, default=0.0, metavar="MS",
        help="stamp a per-request deadline (0 = none) — exercises the "
        "deadline-shed path under load",
    )
    ap.add_argument(
        "--init-missing-checkpoint",
        action="store_true",
        help="write a fresh random checkpoint when model_file is absent",
    )
    ap.add_argument(
        "--stats",
        action="store_true",
        help="poll the live tier's `stats` admin op once (router + "
        "per-replica counters + fleet freshness) and print it as ONE JSON "
        "line — the operator path that needs no JSONL tailing.  Requires "
        "--connect or --spawn",
    )
    ap.add_argument(
        "--probe-freshness",
        type=int,
        default=0,
        metavar="TRIALS",
        help="tagged-probe freshness mode: per trial, score a sentinel id, "
        "publish a checkpoint whose sentinel row changed, and poll the "
        "sentinel's score through the front end until it flips — the "
        "black-box publish→first-scored-with-new-rows SLO.  Emits a "
        "PROBE_FRESHNESS JSON (use --out).  Requires --spawn (the probe "
        "must own model_file to publish)",
    )
    args = ap.parse_args(argv)
    if args.stats and not (args.connect or args.spawn):
        ap.error("--stats requires --connect or --spawn (a live front end)")
    if args.probe_freshness:
        if not args.spawn:
            ap.error(
                "--probe-freshness requires --spawn (the probe publishes "
                "checkpoints into model_file, so it must own the tier)"
            )
        if args.probe_freshness < 2:
            ap.error("--probe-freshness needs >= 2 trials for percentiles")
    if args.mode == "open" and args.qps <= 0:
        ap.error("--qps must be > 0 in open mode (it is the Poisson arrival rate)")
    if args.mode == "closed" and args.concurrency < 1:
        ap.error("--concurrency must be >= 1 in closed mode")
    if args.connections < 1:
        ap.error("--connections must be >= 1")
    if args.connect and args.spawn:
        ap.error("--connect and --spawn are mutually exclusive")
    if args.frame_rows < 1:
        ap.error("--frame-rows must be >= 1")
    if args.processes < 1:
        ap.error("--processes must be >= 1")
    if args.processes > 1 and not (args.connect or args.spawn):
        ap.error("--processes requires the socket transport (--connect/--spawn)")
    if args.processes > 1 and args.mode != "open":
        ap.error("--processes is an open-loop fan-out (use --mode open)")
    if args.worker and not args.connect:
        ap.error("--worker requires --connect (the parent owns the tier)")
    mix = parse_class_mix(args.classes) if args.classes else None

    from fast_tffm_tpu_torch.config import build_model, load_config

    cfg = load_config(args.config)
    if not (args.worker or args.device == "cpu"):
        from fast_tffm_tpu_torch.device import resolve_device

        resolve_device(args.device)  # the card, or raise
    if args.init_missing_checkpoint and not os.path.exists(cfg.model_file.rstrip("/")):
        from fast_tffm_tpu_torch.checkpoint import save_checkpoint

        save_checkpoint(cfg.model_file, fresh_state(cfg, build_model(cfg), args.seed))
        print(f"loadgen: wrote fresh checkpoint {cfg.model_file}", file=sys.stderr)

    log = lambda *a: print(*a, file=sys.stderr)

    if args.stats:
        # One-shot operator poll: the `stats` admin op over the CONTROL
        # path of a live tier, printed as ONE JSON line — router counters,
        # per-replica engine snapshots, fleet freshness percentiles.
        proc = None
        if args.spawn:
            proc, port = spawn_serve(args.config, log=log, device=args.device)
            host = "127.0.0.1"
        else:
            host, _, port = args.connect.rpartition(":")
            host, port = host or "127.0.0.1", int(port)
        try:
            c = ServeConnection(port, host=host)
            try:
                stats = c.request({"op": "stats"}, timeout=60)
            finally:
                c.close()
            print(json.dumps(stats, separators=(",", ":")))
        finally:
            if proc is not None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
        return 0

    if args.probe_freshness:
        return run_freshness_probe(args, cfg, log)

    if args.input:
        lines = [l.strip() for l in open(args.input) if l.strip()]
    elif cfg.predict_files:
        lines = [
            l.strip() for p in cfg.predict_files for l in open(p) if l.strip()
        ]
    else:
        width = cfg.max_nnz if cfg.max_nnz > 0 else 8
        lines = synth_lines(cfg, 4096, width, args.seed)
        print(f"loadgen: synthesized {len(lines)} request lines", file=sys.stderr)

    if args.worker:
        return run_worker(args, cfg, lines, mix)

    res = Results()
    result: dict = {
        "bench": "BENCH_SERVE",
        "mode": args.mode,
        "qps_target": args.qps if args.mode == "open" else None,
        "concurrency": args.concurrency if args.mode == "closed" else None,
        "class_mix": dict(mix) if mix else None,
        "deadline_ms": args.deadline_ms or None,
        "flush_deadline_ms": cfg.serve_flush_deadline_ms,
    }

    if args.connect or args.spawn:
        proc = None
        if args.spawn:
            t_setup = time.perf_counter()
            proc, port = spawn_serve(args.config, log=log, device=args.device)
            host = "127.0.0.1"
            warmup_s = time.perf_counter() - t_setup
        else:
            host, _, port = args.connect.rpartition(":")
            host, port = host or "127.0.0.1", int(port)
            warmup_s = 0.0
        try:
            if args.mode == "open":
                if args.processes > 1:
                    extra = run_multiprocess(args, host, port, res)
                else:
                    extra = drive_open(host, port, lines, cfg, args, mix, res)
                wall = extra.pop("wall")
                # The no-hung-client pin: anything STILL unresolved after
                # the drain window never got its one response.
                result["unanswered"] = extra.pop("unanswered")
                result.update(extra)
            else:
                t0 = time.perf_counter()
                run_closed_socket(port, host, lines, args, mix, res)
                wall = time.perf_counter() - t0
            c = ServeConnection(port, host=host)
            try:
                stats = c.request({"op": "stats"}, timeout=60)
            finally:
                c.close()
            engines = stats.get("engines", {})
            steady = [
                e.get("steady_compiles")
                for e in engines.values()
                if isinstance(e.get("steady_compiles"), int)
            ]
            from fast_tffm_tpu_torch.telemetry import artifact_stamp

            result.update(
                # Join keys: the tier's run_id + envelope schema version —
                # this artifact is joinable to the replicas' JSONL streams.
                **artifact_stamp(stats.get("run_id", "")),
                freshness=stats.get("freshness"),
            )
            result.update(
                transport="socket",
                connections=args.connections if args.mode == "open" else None,
                warmup_s=round(warmup_s, 3),
                server={
                    k: stats.get(k)
                    for k in (
                        "replicas",
                        "failovers",
                        "failed_unanswerable",
                        "reload_fanouts",
                        "mttr_s",
                    )
                },
                engines=engines,
                steady_state_recompiles=max(steady) if steady else None,
            )
        finally:
            if proc is not None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
    else:
        from fast_tffm_tpu_torch.serving.engine import ServingEngine
        from fast_tffm_tpu_torch.serving.replica import launch_counts

        if args.mode == "open" and cfg.serve_overload == "block":
            # A blocking submit would stall the Poisson arrival schedule
            # the moment the queue fills — turning the open loop into a
            # closed one exactly at the queueing-collapse point it exists
            # to expose.  Shed instead; rejects are counted in the result.
            import dataclasses

            cfg = dataclasses.replace(cfg, serve_overload="reject")
            print(
                "loadgen: open-loop mode forces serve_overload = reject "
                "(blocking submits would self-throttle the arrival schedule)",
                file=sys.stderr,
            )
        t_setup = time.perf_counter()
        engine = ServingEngine(cfg, log=log, device=args.device)
        warm = engine.compile_count()  # ladder fully compiled here (ctor warmup)
        warmup_s = time.perf_counter() - t_setup
        t0 = time.perf_counter()
        if args.mode == "open":
            run_open_engine(engine, lines, args, mix, res)
        else:
            run_closed_engine(engine, lines, args, mix, res)
        wall = time.perf_counter() - t0
        end = engine.compile_count()
        snap = engine.metrics_snapshot()
        run_id = engine.run_id
        engine.close()
        from fast_tffm_tpu_torch.telemetry import artifact_stamp

        result.update(
            **artifact_stamp(run_id),
            transport="inprocess",
            warmup_s=round(warmup_s, 3),
            buckets=list(engine.buckets),
            overload=cfg.serve_overload,
            # Flat compile count across the traffic phase IS the
            # acceptance signal: every request shape landed on a warmed
            # bucket.
            compile_count_warm=warm,
            compile_count_end=end,
            steady_state_recompiles=(
                end - warm if warm is not None and end is not None else None
            ),
            kernel_launches=launch_counts(),
            **snap,
        )

    from fast_tffm_tpu_torch.telemetry import device_stamp, write_json_artifact

    result.update(device_stamp(args.device or "cuda"))
    result.update(
        duration_s=round(wall, 3),
        requests_sent=res.sent,
        requests_scored=len(res.lat),
        qps_achieved=round(len(res.lat) / wall, 1) if wall > 0 else None,
        client_ms=percentiles_ms(res.lat),
        client_ms_by_class={
            k: percentiles_ms(v) for k, v in sorted(res.lat_by_class.items())
        },
        shed_codes=dict(sorted(res.codes.items())),
    )
    out = json.dumps(result, indent=2)
    print(out)
    if args.out:
        write_json_artifact(args.out, result, indent=2, sort_keys=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
