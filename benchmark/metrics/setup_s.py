"""Set-up seconds: process start (before torch is imported) to the end of
the warm-up: imports, the kernels' build or load, the epoch and the
starting state drawn on the card, the checked first calls (the K-step
graphs' captures among them) and the warm-up calls."""


def read(r):
    return r.setup_s
