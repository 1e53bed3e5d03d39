"""Process-group bring-up — the counterpart of
``fast_tffm_tpu/parallel/multihost.py``.

In the JAX package one process may drive many devices and
``jax.distributed.initialize`` joins the processes into one runtime.  In
the port one rank is one process is one device: ``dist_train`` and
``dist_predict`` run as ``num_processes`` copies of the same program,
joined by ``torch.distributed`` into one default process group.  Rank r
drives the device ``cuda:<local index>``, its local index being
``LOCAL_RANK`` when the launcher sets it and ``r mod`` the host's CUDA
device count otherwise (one rank per card; NCCL does not put two ranks on
one device).  CPU runs (``device="cpu"``) join a ``gloo`` group, CUDA runs
an ``nccl`` one.  A single-process run creates no group: every collective
of the distributed step has a world-size-1 fast path that calls none.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = [
    "maybe_initialize_distributed",
    "is_multihost",
    "process_index",
    "process_count",
    "local_device",
]


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def local_device(device) -> torch.device:
    """This rank's device: ``cuda:<local index>`` for a CUDA run (see the
    module docstring), the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    local = _env_int("LOCAL_RANK", -1)
    if local < 0:
        local = process_index() % max(1, n)
    return torch.device("cuda", local)


def maybe_initialize_distributed(
    coordinator_address: str = "",
    num_processes: int = 0,
    process_id: int = -1,
    *,
    device="cuda",
    timeout_s: float = 120.0,
) -> bool:
    """Join the default process group when a multi-process context is
    present; returns True when one is (already) initialized.

    Priority: a group the caller already initialized is used as it is (the
    CPU tests initialize one per rank over a ``file://`` store); then the
    explicit arguments (``[Distributed] coordinator_address`` as
    ``host:port`` of rank 0's TCP store, ``num_processes``, ``process_id``);
    then a launcher's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT``).  ``num_processes`` <= 1 with no environment
    touches nothing.  The backend is ``nccl`` for a CUDA device, ``gloo``
    for the CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    num_processes = int(num_processes or _env_int("WORLD_SIZE", 0))
    if num_processes <= 1:
        return False
    if process_id < 0:
        process_id = _env_int("RANK", -1)
    if process_id < 0 or process_id >= num_processes:
        raise ValueError(
            f"[Distributed] process_id {process_id} is not a rank of {num_processes} "
            "processes (set process_id, or RANK in the environment)"
        )
    if coordinator_address:
        addr = coordinator_address
        init_method = addr if "://" in addr else f"tcp://{addr}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError(
            f"num_processes = {num_processes} needs [Distributed] coordinator_address "
            "(host:port of rank 0) or MASTER_ADDR / MASTER_PORT in the environment"
        )
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        local = _env_int("LOCAL_RANK", -1)
        torch.cuda.set_device(local if local >= 0 else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=max(10.0, float(timeout_s))),
    )
    return True


def is_multihost() -> bool:
    return process_count() > 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1
