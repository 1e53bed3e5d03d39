"""The DCN-V2 cross combine pair's (csrc/dcn_cross.cu) share of its
roofline: the least time of its launches in the traced stretch over their
device time.  A launch works on [B, d] float32 rows, B the batch and
d = N·k (n_fields·(row_dim - 1)); its least bytes are what the combine
must move, never what the implementation materializes: forward, x0, h and
x_l read once and y written once (16 B an element); backward, g, x0 and h
read once, d_h and x0's gradient written once (20 B an element).  Bound by
bytes: about a flop for each 4 bytes."""

KERNEL_BYTES = {"dcn_cross_fwd_kernel": 16, "dcn_cross_bwd_kernel": 20}  # a [B, d] element


def read(r):
    if not r.peaks:
        return None
    elements = r.batch_size * r.n_fields * (r.row_dim - 1)
    nbytes, dev = 0.0, 0.0
    for name, s, e in r.trace.device:
        for kernel, per in KERNEL_BYTES.items():
            if kernel in name:
                nbytes += per * elements
                dev += (e - s) / 1e6
    if dev <= 0:
        return None
    return 100.0 * nbytes / r.peaks["hbm_bytes_per_s"] / dev
