"""Kernel B4's (csrc/rows_tail_adagrad.cu) share of its roofline: the
least time of its work in the traced steps (roofline.tail_least_s: M =
B·N occurrences onto each step's U unique rows) over its device time."""

from benchmark import roofline


def read(r):
    dev = r.group_s("rows_tail")
    if dev <= 0 or not r.peaks or not r.unique_per_step:
        return None
    m = r.batch_size * r.n_fields
    least = sum(roofline.tail_least_s(m, u, r.row_dim, r.accum_width, r.peaks)[0]
                for u in r.unique_per_step)
    return 100.0 * least / dev
