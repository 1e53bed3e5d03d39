"""Command line of the port: ``python -m fast_tffm_tpu_torch.cli <verb> <cfg>``.

The ``train``, ``predict`` and ``serve`` verbs of the JAX package's CLI
(``fast_tffm_tpu/cli.py``):

  train <cfg> [--resume]   train on [Train] train_files, validate, save model_file
  predict <cfg>            write one %.6f score per [Predict] predict_files line
                           to score_path
  serve <cfg>              pipe mode: libsvm lines on stdin, one %.6f score
                           per line on stdout

Logs go to stderr.  ``--device`` picks the device (default cuda; there is
no CPU fallback).  The socket front end (``--port`` / ``[Serving] port``)
and the distributed verbs are later slices of the port.
"""

from __future__ import annotations

import argparse
import sys

from fast_tffm_tpu_torch.config import load_config

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fast_tffm_tpu_torch.cli")
    ap.add_argument("mode", choices=["train", "predict", "serve"])
    ap.add_argument("config")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--resume", action="store_true", help="train: restore model_file first")
    args = ap.parse_args(argv)
    if args.resume and args.mode != "train":
        ap.error("--resume applies to the train verb")
    cfg = load_config(args.config)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    if args.mode == "train":
        from fast_tffm_tpu_torch.training import train

        train(cfg, resume=args.resume, log=log, device=args.device)
        return 0
    if args.mode == "predict":
        from fast_tffm_tpu_torch.prediction import predict

        predict(cfg, log=log, device=args.device)
        return 0
    if cfg.serve_port > 0:
        ap.error(
            "[Serving] port > 0: the socket front end is not ported yet (a later "
            "slice of fast_tffm_tpu_torch); pipe mode reads stdin"
        )
    from fast_tffm_tpu_torch.serving import serve_lines

    serve_lines(cfg, log=log, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
