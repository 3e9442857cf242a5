"""The fused rank kernel: filtered rank counts of ``b`` queries against all
``e`` entity rows of width ``d``. l1 takes two fp32 instructions per element
(a subtract, then an add with the |.| modifier); l2 one FMA per element, the
norms and a root per score; dot one FMA per element. Bytes: the queries,
the table, the gold scores, the (b, f) filter and the counts."""
from __future__ import annotations

KERNEL = "fused_rank_kernel"


def instructions(mode: str, b: int, e: int, d: int) -> tuple:
    """(fp32 instructions, square roots)."""
    if mode == "l1":
        return 2 * b * e * d, 0
    if mode == "dot":
        return b * e * d, 0
    if mode == "l2":
        return b * e * d + e * d + b * d, b * e
    return 6 * b * e * (d // 2), b * e * (d // 2)


def bytes_moved(shape: dict) -> int:
    b, e, d, f = shape["b"], shape["e"], shape["d"], shape["f"]
    return 4 * (b * d + e * d + b + b * f + b)


def least_seconds(shape: dict, peaks) -> float:
    instr, roots = instructions(shape["mode"], shape["b"], shape["e"], shape["d"])
    return max(bytes_moved(shape) / peaks.bytes_per_s, instr / peaks.fp32_instr,
               roots / peaks.sfu_instr)
