"""The whole window's counted work at the data-sheet peaks (the larger of
bytes at the memory rate and instructions at their pipe's rate, per launch)
over its wall time, in percent: a roofline share of the whole train."""
from chipbench import readers


def read(ctx):
    return readers.mfu(ctx)
