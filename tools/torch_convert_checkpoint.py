#!/usr/bin/env python
"""Convert a checkpoint between the npz and orbax formats through the port.

    python tools/torch_convert_checkpoint.py <cfg> <src_ckpt> <dst_ckpt> \
        [--format auto|npz|orbax] [--device cpu]

The counterpart of ``tools/convert_checkpoint.py`` for ``fast_tffm_tpu_torch``:
restore → save, with the same destination rule (``auto``: a path ending in
``.orbax`` or ``/`` writes orbax, anything else npz).  The config supplies
the model (its dense leaves' names and the accumulator granularity); the
input cursor of the source travels with the state.  Either package
restores what this writes.  ``--device`` defaults to the card, as every
entry point of the port does.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a checkpoint between the npz and orbax formats (the port)."
    )
    ap.add_argument("config", help="INI config describing the model (see sample.cfg)")
    ap.add_argument("src", help="source checkpoint (npz file or orbax dir)")
    ap.add_argument("dst", help="destination checkpoint path")
    ap.add_argument("--format", choices=("auto", "npz", "orbax"), default="auto",
                    help="destination format (auto = by suffix: .orbax/trailing slash = orbax)")
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card)")
    args = ap.parse_args(argv)

    from fast_tffm_tpu_torch.checkpoint import (
        read_input_cursor,
        restore_checkpoint,
        save_checkpoint,
    )
    from fast_tffm_tpu_torch.config import build_model, load_config
    from fast_tffm_tpu_torch.device import resolve_device

    cfg = load_config(args.config)
    model = build_model(cfg)
    width = model.row_dim if cfg.adagrad_accumulator == "element" else 1
    state = restore_checkpoint(args.src, resolve_device(args.device),
                               n_dense=len(model.dense_names), accum_width=width)
    save_checkpoint(args.dst, state, args.format, cursor=read_input_cursor(args.src),
                    dense_names=model.dense_names)
    print(f"converted {args.src} -> {args.dst} (step {state.step})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
