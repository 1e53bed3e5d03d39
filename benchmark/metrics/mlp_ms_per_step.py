"""The MLP's matrix products' device time a step (cuBLAS's GEMM kernels,
forward and backward)."""


def read(r):
    s = r.group_s("gemm")
    return 1e3 * s / r.steps if s > 0 and r.steps else None
