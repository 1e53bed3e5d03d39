"""Command line of the port: ``python -m fast_tffm_tpu_torch.cli <verb> <cfg>``.

The ``train``, ``predict``, ``serve`` and ``convert`` verbs of the JAX
package's CLI (``fast_tffm_tpu/cli.py``):

  train <cfg> [--resume]   train on [Train] train_files, validate, save model_file
                           (with the input cursor); --resume restores it and
                           reopens the input at the saved batch.  SIGTERM or
                           SIGINT: finish the current call, save, exit 0.
                           --supervised: run the trainer as a child process
                           (this CLI, same config, --device, --metrics-path
                           and one --run-id) and relaunch it with --resume
                           after a crash ([Resilience] restart_max, or
                           --max-restarts; restart_backoff_s, _max_s),
                           repairing a torn delta chain first; kind=fault and
                           kind=restart records (MTTR) to metrics_path.
                           --fault-plan SPEC arms a fault plan
                           (resilience.FaultPlan: 'kill@120,io_error@45,
                           nan@200:210,torn_delta@1,kill_publish@2', or
                           'random:kill=2' from --fault-seed and
                           --fault-horizon); supervised, it arms the first
                           launch only
  predict <cfg>            write one %.6f score per [Predict] predict_files line
                           to score_path
  serve <cfg>              pipe mode: libsvm lines on stdin, one %.6f score
                           per line on stdout.  With --port P (or [Serving]
                           port > 0): the socket tier, a TCP front end over a
                           router and [Serving] replicas worker processes
                           (each an engine on --device); P = 0 is ephemeral,
                           announced as SERVE_READY port=... pid=...
                           replicas=... on stdout; runs until SIGTERM/SIGINT
  convert <cfg>            pack every configured train, validation and predict
                           file into its <file>.fmb cache (one file at a time;
                           rc 1 when any file failed)
  dist_train <cfg>         train over the [data, row] mesh of ranks on
                           torch.distributed: one process per rank and
                           device, [Distributed] num_processes, process_id
                           and coordinator_address (host:port of rank 0) or
                           a launcher's WORLD_SIZE / RANK / MASTER_ADDR /
                           MASTER_PORT; the table row-sharded, each rank
                           parsing its rows of every batch; rank 0 writes
                           the checkpoints.  --resume, --fault-plan and (one
                           process) --supervised as for train
  dist_predict <cfg>       predict over the same mesh; rank 0 writes
                           score_path

The reference's trailing ``job_name task_index`` arguments are taken and
ignored with a note on stderr, as the JAX CLI does.  Logs go to stderr.
``--device`` picks the device (default cuda; there is no CPU fallback;
``convert`` touches no device but keeps the rule).
``--metrics-path``, ``--run-id`` and ``--profile-steps`` override
``[Train] metrics_path``, ``[Telemetry] run_id`` and ``[Telemetry]
profile_steps`` (the JAX CLI's flags): a run is instrumented, and rendered
with ``tools/report.py``, without editing its config.  The pod supervision
of multi-process training (``dist_train --supervised`` with
``num_processes`` > 1, ``--fault-process``) is a later slice of the port.
"""

from __future__ import annotations

import argparse
import os
import sys

from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.profiling import parse_profile_steps
from fast_tffm_tpu_torch.telemetry import enable_compilation_cache

__all__ = ["main", "MODES"]

MODES = ("train", "predict", "dist_train", "dist_predict", "convert", "serve")
_POD = ("the pod supervision of multi-process training (item 10 of ROADMAP.md §A), "
        "which fast_tffm_tpu_torch has not ported yet; use fast_tffm_tpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fast_tffm_tpu_torch.cli")
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("config")
    ap.add_argument("legacy", nargs="*",
                    help="ignored job_name/task_index (the reference's cluster arguments)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--resume", action="store_true",
                    help="train, dist_train: restore model_file first")
    ap.add_argument("--port", type=int, default=None, metavar="P",
                    help="serve: run the socket front end on port P (0 = ephemeral); "
                    "overrides [Serving] port")
    ap.add_argument("--metrics-path", default=None, metavar="PATH",
                    help="telemetry JSONL sink; overrides [Train] metrics_path")
    ap.add_argument("--run-id", default=None, metavar="ID",
                    help="telemetry run id of every record; overrides [Telemetry] run_id")
    ap.add_argument("--profile-steps", default=None, metavar="A:B",
                    help="a torch.profiler trace over steps [A, B) into "
                    "<model_file>.profile (trace_dir overrides); overrides "
                    "[Telemetry] profile_steps")
    ap.add_argument("--supervised", action="store_true",
                    help="train: run the trainer as a supervised child process, relaunched "
                    "with --resume after a crash (bounded restarts, exponential backoff; "
                    "[Resilience] restart_* keys); kind=fault and kind=restart records "
                    "(MTTR) go to metrics_path")
    ap.add_argument("--max-restarts", type=int, default=None, metavar="N",
                    help="override [Resilience] restart_max for --supervised")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="train: arm a fault plan, 'kill@120,io_error@45,nan@200:210,"
                    "torn_delta@1' or 'random:kill=2,io_error=3' drawn from --fault-seed; "
                    "under --supervised it arms the first launch only")
    ap.add_argument("--fault-seed", type=int, default=0, metavar="N",
                    help="seed of random: fault plans (same seed, same schedule)")
    ap.add_argument("--fault-horizon", type=int, default=1000, metavar="STEPS",
                    help="step horizon random: fault plans draw positions from")
    ap.add_argument("--fault-process", type=int, default=None, metavar="P",
                    help="not ported: the pod-supervised dist_train's fault placement")
    args = ap.parse_args(argv)
    training = args.mode in ("train", "dist_train")
    if args.resume and not training:
        ap.error("--resume applies to the train and dist_train verbs")
    if (args.supervised or args.fault_plan) and not training:
        ap.error("--supervised and --fault-plan apply to the train verb (and dist_train)")
    if args.fault_process is not None:
        ap.error(f"--fault-process places faults on the processes of a pod-supervised "
                 f"dist_train: {_POD}")
    if args.port is not None and args.mode != "serve":
        ap.error("--port applies to the serve verb")
    cfg = load_config(args.config)
    if args.metrics_path is not None:
        cfg.metrics_path = args.metrics_path
    if args.run_id is not None:
        cfg.telemetry_run_id = args.run_id
    if args.profile_steps is not None:
        parse_profile_steps(args.profile_steps)  # fail fast on a bad spec
        cfg.telemetry_profile_steps = args.profile_steps

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    if args.legacy:
        # The JAX CLI's note; a supervised run's children are launched
        # without them.
        log(f"note: ignoring legacy cluster args {args.legacy!r} — the SPMD mesh "
            "replaces ps/worker tasks (one launch drives all devices)")

    if cfg.telemetry_compilation_cache_dir:
        enable_compilation_cache(cfg.telemetry_compilation_cache_dir, log)

    if training and args.supervised:
        if args.mode == "dist_train" and cfg.num_processes > 1:
            ap.error(f"dist_train --supervised with num_processes = {cfg.num_processes} is {_POD}")
        return _supervise(cfg, args, log)
    if training:
        from fast_tffm_tpu_torch.training import dist_train, train

        step_hook = None
        if args.fault_plan:
            from fast_tffm_tpu_torch.resilience import FaultPlan, install_faults

            inj = install_faults(FaultPlan.parse(args.fault_plan, seed=args.fault_seed,
                                                 horizon=args.fault_horizon))
            log(f"fault plan armed: {inj.plan.to_json()}")
            step_hook = inj.step_hook
        run = train if args.mode == "train" else dist_train
        run(cfg, resume=args.resume, log=log, device=args.device, step_hook=step_hook)
        return 0
    if args.mode in ("predict", "dist_predict"):
        from fast_tffm_tpu_torch.prediction import dist_predict, predict

        (predict if args.mode == "predict" else dist_predict)(cfg, log=log, device=args.device)
        return 0
    if args.mode == "convert":
        from fast_tffm_tpu_torch.device import resolve_device

        resolve_device(args.device)
        return _convert(cfg)
    if args.port is not None or cfg.serve_port > 0:
        from fast_tffm_tpu_torch.device import resolve_device
        from fast_tffm_tpu_torch.serving.frontend import run_frontend

        resolve_device(args.device)  # the replicas inherit it; fail here first
        return run_frontend(cfg, args.config, port=args.port, device=args.device, log=log)
    from fast_tffm_tpu_torch.serving import serve_lines

    serve_lines(cfg, log=log, device=args.device)
    return 0


def _supervise(cfg, args, log) -> int:
    """``train --supervised`` (and one-process ``dist_train --supervised``):
    this process stays off the device (it imports no torch) and runs
    ``python -m fast_tffm_tpu_torch.cli <verb>`` as its child under
    ``resilience.Supervisor``, relaunching it with ``--resume`` after a
    crash.  The supervisor's records and every child's share one run id."""
    from fast_tffm_tpu_torch.resilience import Supervisor
    from fast_tffm_tpu_torch.telemetry import new_run_id

    if not cfg.telemetry_run_id:
        cfg.telemetry_run_id = new_run_id()
    base = [sys.executable, "-m", "fast_tffm_tpu_torch.cli", args.mode, args.config,
            "--device", args.device]
    if args.metrics_path is not None:
        base += ["--metrics-path", args.metrics_path]
    if args.profile_steps is not None:
        base += ["--profile-steps", args.profile_steps]
    base += ["--run-id", cfg.telemetry_run_id]
    # The child finds the package where this process found it.
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else pkg_root)

    def build_cmd(attempt: int, resume: bool) -> list[str]:
        cmd = list(base)
        if resume:
            cmd += ["--resume"]
        if args.fault_plan and attempt == 0:
            # The plan arms the first launch only: a kill armed again on
            # every relaunch would crash for ever.
            cmd += ["--fault-plan", args.fault_plan, "--fault-seed", str(args.fault_seed),
                    "--fault-horizon", str(args.fault_horizon)]
        return cmd

    sup = Supervisor(
        build_cmd,
        model_file=cfg.model_file,
        max_restarts=args.max_restarts if args.max_restarts is not None else cfg.restart_max,
        backoff_s=cfg.restart_backoff_s,
        backoff_max_s=cfg.restart_backoff_max_s,
        metrics_path=cfg.metrics_path or None,
        run_id=cfg.telemetry_run_id,
        log=log,
        child_log=print,
        env=env,
    )
    return sup.run(resume=args.resume)


def _convert(cfg) -> int:
    """Pre-pack every configured data file into its FMB cache (what
    ``binary_cache = true`` does at the first stream).  One file at a time:
    the all-or-nothing text fallback is a rule of one stream, and these
    files feed separate streams, so one unwritable or malformed file fails
    alone.  Returns 1 when any file failed."""
    from fast_tffm_tpu_torch.data.binary import ensure_fmb_cache, is_fmb

    files = tuple(dict.fromkeys((*cfg.train_files, *cfg.validation_files, *cfg.predict_files)))
    if not files:
        print("no data files configured", file=sys.stderr)
        return 1
    if not cfg.binary_cache:
        print(
            "note: this config has binary_cache = false — set it to true "
            "(or put the .fmb paths in the file lists) so train/predict "
            "actually stream the packed caches",
            file=sys.stderr,
        )
    failures = 0
    for src in files:
        try:
            (dst,) = ensure_fmb_cache(
                [src], vocabulary_size=cfg.vocabulary_size,
                hash_feature_id=cfg.hash_feature_id, max_nnz=cfg.max_nnz or None, log=print,
            )
        except (OSError, ValueError, RuntimeError) as e:
            print(f"{src}: FAILED ({e})", file=sys.stderr)
            failures += 1
            continue
        if dst == src and not is_fmb(src):  # the unwritable-location fallback
            print(f"{src}: FAILED (cache location unwritable)", file=sys.stderr)
            failures += 1
        elif src == dst:
            print(f"{src} (already FMB)")
        else:
            print(f"{src} -> {dst}")
    if failures:
        print(f"{failures} of {len(files)} files not converted", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
