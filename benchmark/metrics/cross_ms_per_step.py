"""The DCN-V2 cross combine's device time a step: the kernels named
dcn_cross_fwd_kernel and dcn_cross_bwd_kernel (csrc/dcn_cross.cu), one of
each a cross layer a step.  The cross layers' products are cuBLAS's and
are not counted here."""

from benchmark import devtrace

KERNELS = ("dcn_cross_fwd_kernel", "dcn_cross_bwd_kernel")


def read(r):
    s = devtrace.group_seconds(r.trace, KERNELS)
    return 1e3 * s / r.steps if s > 0 and r.steps else None
