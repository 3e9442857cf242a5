"""Percent of the window in which no kernel ran (the union of kernel
intervals in the trace)."""
from chipbench import readers


def read(ctx):
    return readers.idle_share(ctx)
