"""Materializing oracles for pairwise scores and fused ranks (tests only).

Like the JAX package's ``triple_score/ref.py``, these compute the distance
directly from the broadcast difference (``l2`` is ``-sqrt(Σ(q-e)²+1e-12)``,
not the clamped expansion the kernels use) and build the whole (B, E)
matrix."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.triple_score.ops import sqrt_rn


def _scores_ref(q: torch.Tensor, ent: torch.Tensor, mode: str) -> torch.Tensor:
    q = q.float()
    ent = ent.float()
    if mode == "dot":
        return q @ ent.T
    diff = q[:, None, :] - ent[None, :, :]
    if mode == "l2":
        return -sqrt_rn(diff.square().sum(-1) + 1e-12)
    if mode == "cl1":
        d2 = q.shape[1] // 2
        dr, di = diff[..., :d2], diff[..., d2:]
        return -sqrt_rn(dr * dr + di * di + 1e-12).sum(-1)
    return -diff.abs().sum(-1)


def pairwise_scores_ref(q: torch.Tensor, ent: torch.Tensor, *, ord_: int = 1,
                        mode: Optional[str] = None) -> torch.Tensor:
    """(B, d) × (E, d) → (B, E); score = −‖q_i − e_j‖_ord (or q·e for dot)."""
    return _scores_ref(q, ent, mode or ("l2" if ord_ == 2 else "l1"))


def fused_ranks_ref(q: torch.Tensor, ent: torch.Tensor, gold: torch.Tensor,
                    filt: torch.Tensor, *, mode: str = "l1") -> torch.Tensor:
    """Oracle for the streaming kernel — materializes (B, E)."""
    s = _scores_ref(q, ent, mode)
    ids = torch.arange(ent.shape[0], dtype=torch.int32, device=ent.device)
    excl = (filt[:, :, None] == ids[None, None, :]).any(dim=1)
    beats = (s > gold[:, None]) & ~excl
    return beats.sum(dim=1, dtype=torch.int32)
