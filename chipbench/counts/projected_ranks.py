"""The projected rank kernel (TransR): filtered rank counts of ``b`` query
rows in ``g`` relation groups against all ``e`` entity rows of width ``d``,
each group's entity table projected through its relation's d x d matrix.
Counted as the work, whatever implements it:

- bytes: the entity table once, each group's matrix and relation row, the
  queries, the (b, f) filter, the counts and the gold ids;
- tensor-core time: the projection, 2 g e d^2 FLOP, at fp32 accuracy on the
  tensor cores, which is three TF32 products a product (split TF32);
- fp32 instructions: the L1 scan of the projected rows, two a (row, entity,
  column) (a subtract, then an add with the |.| modifier).

The least time is the largest of the three. A kernel that pads d or runs on
the fp32 pipes reads as a lower share, never above 100%."""
from __future__ import annotations

KERNEL = "projected_rank_kernel"

#: NVIDIA H100 SXM5 data sheet: dense TF32 on the tensor cores, at the 700 W
#: limit (the benchmark's ``peaks.py`` holds no tensor-core rate)
TF32_FLOPS = 495e12


def bytes_moved(shape: dict) -> int:
    b, g, e, d, f = shape["b"], shape["g"], shape["e"], shape["d"], shape["f"]
    return 4 * (e * d + g * d * d + g * d + b * d + b * f + 2 * b)


def tensor_seconds(shape: dict) -> float:
    return 3 * 2 * shape["g"] * shape["e"] * shape["d"] ** 2 / TF32_FLOPS


def least_seconds(shape: dict, peaks) -> float:
    scan = 2 * shape["b"] * shape["e"] * shape["d"]
    return max(bytes_moved(shape) / peaks.bytes_per_s, tensor_seconds(shape),
               scan / peaks.fp32_instr)
