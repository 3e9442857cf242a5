"""Materializing oracles for the CSLS kernel (tests only).

Like the JAX package's ``csls/ref.py`` these normalise each row as
``x / (‖x‖ + 1e-9)`` before the product, where the kernel scales the raw
dot product by ``1 / sqrt(Σx² + 1e-18)`` of each row, and they take the
top-k means from a full sort."""
from __future__ import annotations

import torch

from repro_torch.kernels.triple_score.ops import sqrt_rn


def cosine_matrix_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float(), b.float()
    an = a / (sqrt_rn((a * a).sum(-1, keepdim=True)) + 1e-9)
    bn = b / (sqrt_rn((b * b).sum(-1, keepdim=True)) + 1e-9)
    return an @ bn.T


def csls_matrix_ref(a: torch.Tensor, b: torch.Tensor, k: int = 10) -> torch.Tensor:
    sim = cosine_matrix_ref(a, b)
    kk = min(k, sim.shape[1])
    kk2 = min(k, sim.shape[0])
    r_a = torch.sort(sim, dim=1).values[:, -kk:].mean(1)
    r_b = torch.sort(sim, dim=0).values[-kk2:, :].mean(0)
    return 2 * sim - r_a[:, None] - r_b[None, :]


def csls_argmax_ref(a: torch.Tensor, b: torch.Tensor, k: int = 10) -> torch.Tensor:
    """Each row's argmax over the whole materialized CSLS matrix, as the
    JAX package's ``csls_retrieval_acc`` takes it."""
    return csls_matrix_ref(a, b, k).argmax(1)
