"""The whole step's share of the card's peak: the least time of the traced
steps over the stretch's wall time.  A step's least time is the larger of
its irreducible bytes over the memory rate and the model's operations
over the compute rate at the precision the configuration states
(roofline.step_least_s), U counted from each traced batch."""

from benchmark import roofline


def read(r):
    if not r.peaks or not r.unique_per_step or r.window_s <= 0:
        return None
    least = sum(
        roofline.step_least_s(r.batch_size, r.n_fields, u, r.row_dim, r.accum_width,
                              r.dense_numel, r.flops_per_step, r.peaks)[0]
        for u in r.unique_per_step
    )
    return 100.0 * least / r.window_s
