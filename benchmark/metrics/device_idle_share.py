"""The share of the traced stretch in which no operation ran on the
device: 1 - the union of the device's busy intervals over the stretch."""


def read(r):
    if not r.trace.device or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
