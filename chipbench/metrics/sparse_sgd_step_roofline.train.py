"""The fused epoch kernel's least time (its bytes at the memory rate) over
its device time in the trace, in percent."""
from chipbench import readers


def read(ctx):
    return readers.roofline(ctx, "sparse_sgd_step")
