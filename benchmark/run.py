"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the card(s) the cell
asks for; exits non-zero with no result line without them.  The last line
of standard output is the result object; the numbers the comparison
read, each beside its limit, are the last lines of standard error.
Build and kernel caches stay inside the checkout (``.bench_cache/``; the
port builds its kernels into ``fast_tffm_tpu_torch/_build/``), and so does
Python's bytecode cache: where the environment sets
``PYTHONDONTWRITEBYTECODE``, every process would otherwise compile torch's
sources anew (on the H100 host, ``import torch`` took 7.5-8.7 s without
the cache and 3.7-3.9 s with it).
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _sub)
sys.dont_write_bytecode = False
sys.pycache_prefix = os.path.join(ROOT, ".bench_cache", "pycache")
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
