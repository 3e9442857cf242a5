"""A plain reference for TransR's link prediction, for the CPU tests of the
port's projected-rank path: plain PyTorch in float64, one row at a time over
the whole entity table, ``s(h, r, t) = −‖h·M_r + r − t·M_r‖₁``. It imports
neither the port nor JAX.

Ranks are bands, as the port's other rank tests hold them: the entities
outside the row's filter that score above gold by more than the near-tie
margin ``1e-5·(1 + |gold|)`` (``lo``), and the same counting the near ties in
(``hi``). The port projects in split TF32 (three TF32 products, as accurate
as float32) and sums in float32, so its count may fall anywhere in the band.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

TOL = 1e-5


def tables(seed: int, e: int, r: int, d: int, spread: float = 0.05):
    """ent and rel uniform in ±6/√d; proj the identity plus ``spread`` times
    a standard normal, so that the projection moves every score."""
    g = torch.Generator().manual_seed(seed)
    b = 6.0 / math.sqrt(d)
    ent = torch.rand(e, d, generator=g) * 2 * b - b
    rel = torch.rand(r, d, generator=g) * 2 * b - b
    proj = torch.eye(d)[None].repeat(r, 1, 1) + spread * torch.randn(r, d, d, generator=g)
    return {"ent": ent, "rel": rel, "proj": proj}


def scores(params, fixed: int, r: int, side: str) -> torch.Tensor:
    """(E,) float64 scores of every entity in the open slot of a row."""
    ent, m = params["ent"].double(), params["proj"][r].double()
    sign = 1.0 if side == "tail" else -1.0
    q = ent[fixed] @ m + sign * params["rel"][r].double()
    return -(q[None] - ent @ m).abs().sum(1)


def rank_bands(params, fixed, gold, r, filt, side: str) -> Tuple[np.ndarray, np.ndarray]:
    """Count bands (lo, hi) of each row: the entities not listed in its
    ``filt`` row that beat its gold entity's score."""
    lo, hi = [], []
    for i in range(len(fixed)):
        s = scores(params, int(fixed[i]), int(r[i]), side)
        g = s[int(gold[i])]
        keep = torch.ones_like(s, dtype=torch.bool)
        ids = [int(x) for x in np.asarray(filt[i]).reshape(-1) if 0 <= int(x) < len(s)]
        keep[ids] = False
        margin = TOL * (1 + abs(float(g)))
        lo.append(int(((s > g + margin) & keep).sum()))
        hi.append(int(((s > g - margin) & keep).sum()))
    return np.array(lo), np.array(hi)


def topk(params, h, r, filt, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(best (B, k) scores, all (B, E) scores with filtered entities at
    −inf) of the tails of (h, r)."""
    best, every = [], []
    for i in range(len(h)):
        s = scores(params, int(h[i]), int(r[i]), "tail")
        ids = [int(x) for x in np.asarray(filt[i]).reshape(-1) if 0 <= int(x) < len(s)]
        s[ids] = -math.inf
        best.append(s.topk(k).values.numpy())
        every.append(s.numpy())
    return np.stack(best), np.stack(every)
