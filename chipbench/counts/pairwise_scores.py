"""The pairwise score kernel: a (b, c) score block of ``b`` queries against
``c`` entity rows of width ``d`` (one launch per entity chunk of a top-k
scan). Instructions as ``fused_ranks``; bytes: the queries, the chunk of the
table and the (b, c) scores written."""
from __future__ import annotations

from chipbench.counts.fused_ranks import instructions

KERNEL = "pairwise_kernel"


def bytes_moved(shape: dict) -> int:
    b, c, d = shape["b"], shape["c"], shape["d"]
    return 4 * (b * d + c * d + b * c)


def least_seconds(shape: dict, peaks) -> float:
    instr, roots = instructions(shape["mode"], shape["b"], shape["c"], shape["d"])
    return max(bytes_moved(shape) / peaks.bytes_per_s, instr / peaks.fp32_instr,
               roots / peaks.sfu_instr)
