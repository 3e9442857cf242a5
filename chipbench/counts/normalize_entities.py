"""The entity-norm projection after an epoch: every row of the (e, d)
entity table read once and written once."""
from __future__ import annotations


def bytes_moved(shape: dict) -> int:
    return 2 * 4 * shape["e"] * shape["d"]


def least_seconds(shape: dict, peaks) -> float:
    return bytes_moved(shape) / peaks.bytes_per_s
