"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

The counterpart of ``fast_tffm_tpu/ops/pallas_common.py``: the one place
that decides how a kernel gets to run.  Each ``csrc/<name>.cu`` exposes a
plain C interface and is compiled on its own into
``fast_tffm_tpu_torch/_build/lib<name>.so`` (gitignored) for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>.so csrc/<name>.cu

A source may include the shared headers ``csrc/*.cuh``.  A library is
built at its first use in a process, or again when its source or a header
is newer.  Without ``nvcc``, or when a build fails, this raises; it never
hands back a plain version in place of a kernel.  ``build`` starts one
``nvcc`` per source, all at once, for callers that want every kernel ready
before traffic (chip_smoke.py).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "fast_tffm_tpu_torch are built from csrc/ at first use and there is "
        "no fallback to the plain versions on a CUDA tensor"
    )


def _paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def build(names) -> dict[str, dict]:
    """Compile every named source in parallel; returns per kernel the build
    seconds and the compiler's output (``-Xptxas=-v`` register/spill lines).
    Raises RuntimeError naming every kernel that failed."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        src, lib = _paths(name)
        if not os.path.isfile(src):
            raise RuntimeError(f"no CUDA source for kernel {name!r} at {src}")
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, lib, time.perf_counter())
    report, failures = {}, []
    for name, (proc, tmp, lib, t0) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "log": out}
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first when missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = _paths(name)
            inputs = [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
            stale = not os.path.isfile(path) or any(
                os.path.isfile(f) and os.path.getmtime(f) > os.path.getmtime(path) for f in inputs
            )
            if stale:
                build([name])
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
