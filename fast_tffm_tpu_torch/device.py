"""The device rule every port entry point follows.

``None`` means the card: a caller that wants the CPU says so with
``device="cpu"`` (the tests do).  A missing CUDA device raises — nothing
quietly runs on the CPU in its place.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda``; a CUDA request without a CUDA device raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: fast_tffm_tpu_torch runs on the GPU "
            "unless the caller passes device='cpu' explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda | cpu)")
    return dev
