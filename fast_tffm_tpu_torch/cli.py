"""Command line of the port: ``python -m fast_tffm_tpu_torch.cli serve <cfg>``.

Pipe mode of the JAX package's ``serve`` verb (``fast_tffm_tpu/cli.py``):
libsvm lines on stdin, one ``%.6f`` score per line on stdout, logs on
stderr.  ``--device`` picks the device (default cuda; there is no CPU
fallback).  The socket front end (``--port`` / ``[Serving] port``) and the
train/predict verbs are later slices of the port.
"""

from __future__ import annotations

import argparse
import sys

from fast_tffm_tpu_torch.config import load_config

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fast_tffm_tpu_torch.cli")
    ap.add_argument("mode", choices=["serve"])
    ap.add_argument("config")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    if cfg.serve_port > 0:
        ap.error(
            "[Serving] port > 0: the socket front end is not ported yet (a later "
            "slice of fast_tffm_tpu_torch); pipe mode reads stdin"
        )
    from fast_tffm_tpu_torch.serving import serve_lines

    serve_lines(cfg, log=lambda *a: print(*a, file=sys.stderr), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
