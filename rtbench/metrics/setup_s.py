"""Seconds from the start of the run to the window: imports, the kernels'
build or load, the inputs, prepare where the cell prepares in set-up,
and the warm-up call (host clock)."""


def read(rec: dict):
    return rec.get("setup_s")
