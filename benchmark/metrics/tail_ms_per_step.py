"""The sparse tail's device time a step: torch.sort's radix-sort kernels
and the Adagrad tail kernel (B4, or B3 on the fused layout)."""


def read(r):
    s = r.group_s("sort", "rows_tail", "fused_tail")
    return 1e3 * s / r.steps if s > 0 and r.steps else None
