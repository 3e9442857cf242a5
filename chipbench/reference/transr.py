"""Plain reference for TransR (L1) filtered tail ranks:
``s(h, r, t) = −‖h·M_r + r − t·M_r‖₁``. Plain PyTorch over the whole tables,
relation by relation and block by block of entities; nothing of the port
imported. Products run in float32 with TF32 off for matmul and cuDNN, unless
the caller asks for one TF32 product (the ``tf32`` control) or passes
bfloat16 tables (the ``bf16`` control).

The rank is held as a band, as in ``kge.rank_bands``: the entities outside
the filter (the known tails of (h, r) and t itself) that score above gold
by more than the near-tie margin ``1e-5·(1 + |gold|)``, plus one, and the
same counting the near ties in. Why that margin: the program projects in
split TF32 (three TF32 products, as accurate as float32) and sums in
another order than this reference, so a score may differ from this one by a
few float32 roundings of the projected values, summed over d = 100 columns:
about 1e-6 of |gold| (|gold| is 30-40 here). 1e-5·(1 + |gold|) holds that
tenfold, where one TF32 product (2⁻¹¹ of each operand, ~3e-4 of a projected
value) moves a score by ~1e-3 and the rank by many entities.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch

from chipbench.reference.kge import KnownTails, filter_mask


@contextmanager
def tf32(allow: bool):
    """Matmul and cuDNN TF32 set to ``allow`` inside, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def rank_bands(ent: torch.Tensor, proj: torch.Tensor, rel: torch.Tensor, h, r, t,
               known: KnownTails, *, allow_tf32: bool = False, tol: float = 1e-5,
               block: int = 65536, chunk: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Filtered tail ranks of (h, r, t) as bands (lo, hi), in the tables'
    dtype: for each relation of the rows, its queries ``h·M_r + r`` and gold
    scores, then the projected entity table ``ent·M_r`` ``block`` rows at a
    time against them."""
    dev = ent.device
    h, r, t = (np.asarray(x, np.int64) for x in (h, r, t))
    lo = np.zeros(len(h), np.int64)
    hi = np.zeros(len(h), np.int64)
    with tf32(allow_tf32):
        for rid in np.unique(r):
            rows = np.flatnonzero(r == rid)
            m = proj[int(rid)]
            q = ent[torch.as_tensor(h[rows], device=dev)] @ m + rel[int(rid)]
            gold = -(q - ent[torch.as_tensor(t[rows], device=dev)] @ m).abs().sum(1).float()
            excl = filter_mask(known, h[rows], r[rows], ent.shape[0], dev)
            excl[torch.arange(len(rows), device=dev), torch.as_tensor(t[rows], device=dev)] = True
            margin = (tol * (1 + gold.abs()))[:, None]
            above = torch.zeros(len(rows), dtype=torch.int64, device=dev)
            near = torch.zeros(len(rows), dtype=torch.int64, device=dev)
            for c0 in range(0, ent.shape[0], block):
                tab = ent[c0:c0 + block] @ m
                for j in range(0, len(rows), chunk):  # bounds the (rows, block, d) difference
                    s = -(q[j:j + chunk, None, :] - tab[None]).abs().sum(-1).float()
                    keep = ~excl[j:j + chunk, c0:c0 + block]
                    g = gold[j:j + chunk, None]
                    above[j:j + chunk] += ((s > g + margin[j:j + chunk]) & keep).sum(1)
                    near[j:j + chunk] += ((s > g - margin[j:j + chunk]) & keep).sum(1)
            lo[rows] = (above + 1).cpu().numpy()
            hi[rows] = (near + 1).cpu().numpy()
    return lo, hi
