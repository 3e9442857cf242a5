"""The projected rank kernel's least time over its device time, in percent."""
from chipbench import readers


def read(ctx):
    return readers.roofline(ctx, "projected_ranks")
