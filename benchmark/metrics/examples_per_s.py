"""Examples trained per second: every example of every call issued in the
window over the window's wall time, first call to the closing sync."""


def read(r):
    return r.examples / r.window_s if r.window_s > 0 and r.examples else None
