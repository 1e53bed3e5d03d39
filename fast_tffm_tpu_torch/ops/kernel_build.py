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
before traffic (chip_smoke.py).  Each build counts as one compile for the
telemetry's compile sentinel (``telemetry.note_compile``); a library
loaded from ``_build/`` without a build counts as a cache hit.

The port's host code in C++ (``csrc/<name>.cpp``, the native libsvm
parser) builds the same way with ``g++`` (``load_host``):

    g++ -O2 -fPIC -std=c++17 -pthread -shared -o _build/lib<name>.so csrc/<name>.cpp

Without ``g++``, or when that build fails, ``load_host`` raises too: the
caller never falls back to a slower path than the one it asked for.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from fast_tffm_tpu_torch.telemetry import note_cache_hit, note_compile

__all__ = [
    "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "nvcc_path", "build", "load",
    "load_host",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

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
        note_compile()
        report[name] = {"seconds": time.perf_counter() - t0, "log": out}
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return report


def _stale(path: str, inputs) -> bool:
    return not os.path.isfile(path) or any(
        os.path.isfile(f) and os.path.getmtime(f) > os.path.getmtime(path) for f in inputs
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first when missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, path = _paths(name)
            if _stale(path, [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
                build([name])
            else:
                note_cache_hit()
            lib = _libs[name] = ctypes.CDLL(path)
        return lib


def _build_host(src: str, lib: str) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(
            f"g++ not found on PATH: {os.path.basename(src)} of fast_tffm_tpu_torch is "
            "built at first use and there is no fallback to a slower path"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"host build of {os.path.basename(src)} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        note_compile()
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of host source ``csrc/<name>.cpp``, built with
    ``g++`` first when missing or older than its source.  Raises when the
    build fails."""
    with _lock:
        key = f"host:{name}"
        lib = _libs.get(key)
        if lib is None:
            src = os.path.join(CSRC_DIR, f"{name}.cpp")
            path = os.path.join(BUILD_DIR, f"lib{name}.so")
            if not os.path.isfile(src):
                raise RuntimeError(f"no host source {name!r} at {src}")
            if _stale(path, [src]):
                _build_host(src, path)
            else:
                note_cache_hit()
            lib = _libs[key] = ctypes.CDLL(path)
        return lib
