"""The fused epoch kernel: ``nb`` margin-SGD steps of ``batch`` triples at
width ``d`` over {ent, rel} tables. Least bytes: in each step every unique
entity and relation row it names read once and written once (fp32), the
step's six int64 ids per triple read, its loss written. The operations are
a few per row element and never bound it."""
from __future__ import annotations

import torch

KERNEL = "epoch_kernel"


def unique_rows(pos: torch.Tensor, neg: torch.Tensor) -> tuple:
    """(entity rows, relation rows) that an epoch's (nb, B, 3) positive and
    negative batches touch, summed over its steps, each step's duplicates
    counted once."""
    def per_step(occ):
        srt = occ.sort(dim=1).values
        return int(((srt[:, 1:] != srt[:, :-1]).sum(1) + 1).sum())

    ent = torch.cat([pos[..., 0], pos[..., 2], neg[..., 0], neg[..., 2]], 1)
    rel = torch.cat([pos[..., 1], neg[..., 1]], 1)
    return per_step(ent), per_step(rel)


def bytes_moved(shape: dict) -> int:
    nb, b, d = shape["nb"], shape["batch"], shape["d"]
    return 2 * 4 * d * (shape["unique_ent"] + shape["unique_rel"]) + 8 * 6 * b * nb + 4 * nb


def least_seconds(shape: dict, peaks) -> float:
    return bytes_moved(shape) / peaks.bytes_per_s
