"""Aligned-entity registry + CSLS (cross-domain similarity local scaling).

The paper assumes aligned entities/relations are given (matched via secure
hash of canonical URIs — footnote 4). ``AlignmentRegistry`` plays that role:
it stores, per KG pair, index arrays into each side's embedding tables.

CSLS (MUSE) scales cosine similarity by the mean similarity to each point's
k nearest neighbours, mitigating hubness; it is the translation-quality
metric of a handshake. ``csls`` and ``csls_retrieval_acc`` take their cosine
tiles from ``kernels.csls`` (the CUDA kernel for CUDA tensors, its plain
version for CPU tensors). ``csls_retrieval_acc`` never holds the (n, m)
matrix: at the paper's largest alignment (123,853 pairs) it would be 61 GB.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels.csls.ops import cosine_matrix, csls_matrix
from repro_torch.kernels.triple_score.ops import sqrt_rn

#: rows of ``a`` per cosine launch in ``csls_retrieval_acc``: a 4,096 ×
#: 123,853 block is 2.0 GB of float32
RETRIEVAL_BLOCK = 4096


def cosine_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain (n, m) cosines, rows normalised as ``x / (‖x‖ + 1e-9)``."""
    an = a / (sqrt_rn((a * a).sum(-1, keepdim=True)) + 1e-9)
    bn = b / (sqrt_rn((b * b).sum(-1, keepdim=True)) + 1e-9)
    return an @ bn.T


def csls(a: torch.Tensor, b: torch.Tensor, k: int = 10) -> torch.Tensor:
    """CSLS(a_i, b_j) = 2·cos(a_i, b_j) − r_B(a_i) − r_A(b_j), (n, m)."""
    return csls_matrix(a, b, k=k)


@torch.no_grad()
def csls_argmax(a: torch.Tensor, b: torch.Tensor, k: int = 10, *,
                block: int = RETRIEVAL_BLOCK) -> torch.Tensor:
    """(n,) int64: each row's CSLS-argmax column, without the (n, m) matrix.

    Two passes over ``block``-row slices of ``a``, one cosine launch per
    slice and pass: the first takes each row's top-k mean (r_A) and keeps a
    running top-k per column (for r_B); the second takes each row's argmax
    of ``2·cos − r_A − r_B``. Ties go to the first column, as in ``argmax``."""
    n, m = a.shape[0], b.shape[0]
    kk2 = min(k, n)
    r_a = torch.empty(n, dtype=torch.float32, device=a.device)
    col_top = None
    for i0 in range(0, n, block):
        sim = cosine_matrix(a[i0:i0 + block], b)
        r_a[i0:i0 + block] = torch.topk(sim, min(k, m), dim=1).values.mean(1)
        top = torch.topk(sim, min(kk2, sim.shape[0]), dim=0).values
        if col_top is not None:
            top = torch.cat([col_top, top])
            top = torch.topk(top, min(kk2, top.shape[0]), dim=0).values
        col_top = top
        del sim
    r_b = col_top.mean(0)
    out = torch.empty(n, dtype=torch.int64, device=a.device)
    for i0 in range(0, n, block):
        sim = cosine_matrix(a[i0:i0 + block], b)
        out[i0:i0 + block] = (2 * sim - r_a[i0:i0 + block, None] - r_b[None, :]).argmax(1)
        del sim
    return out


def csls_retrieval_acc(a: torch.Tensor, b: torch.Tensor, k: int = 10, *,
                       block: int = RETRIEVAL_BLOCK) -> float:
    """Fraction of rows whose CSLS-argmax is the correct (diagonal) match,
    computed blockwise by ``csls_argmax``."""
    n = a.shape[0]
    if n == 0:
        return float("nan")
    hits = csls_argmax(a, b, k, block=block) == torch.arange(n, device=a.device)
    return int(hits.sum()) / n


def procrustes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Orthogonal R minimizing ||a·R − b||_F (MUSE refinement step): the
    polar factor ``u @ vt`` of ``aᵀb``, free of the SVD's sign choices.

    Used HOST-LOCALLY on (DP-released G(X), host's own Y): post-processing a
    differentially-private output together with data the processor already
    owns, so it does not change the (ε, δ) guarantee of the release.
    """
    m = a.T @ b
    u, _, vt = torch.linalg.svd(m, full_matrices=False)
    return u @ vt


class AlignmentRegistry:
    """Pairwise aligned entity/relation local-index maps between KGs."""

    def __init__(self):
        self._ent: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}
        self._rel: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}

    @staticmethod
    def from_kgs(kgs: Dict[str, "object"]) -> "AlignmentRegistry":
        reg = AlignmentRegistry()
        names = list(kgs)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                ia, ib = kgs[a].aligned_with(kgs[b])
                if len(ia):
                    reg.add_entities(a, b, ia, ib)
        return reg

    def add_entities(self, a: str, b: str, idx_a, idx_b):
        self._ent[(a, b)] = (np.asarray(idx_a), np.asarray(idx_b))
        self._ent[(b, a)] = (np.asarray(idx_b), np.asarray(idx_a))

    def add_relations(self, a: str, b: str, idx_a, idx_b):
        self._rel[(a, b)] = (np.asarray(idx_a), np.asarray(idx_b))
        self._rel[(b, a)] = (np.asarray(idx_b), np.asarray(idx_a))

    def entities(self, a: str, b: str):
        return self._ent.get((a, b))

    def relations(self, a: str, b: str):
        return self._rel.get((a, b))

    def partners(self, a: str) -> List[str]:
        return sorted({b for (x, b) in self._ent if x == a})

    def num_aligned(self, a: str, b: str) -> int:
        ent = self._ent.get((a, b))
        rel = self._rel.get((a, b))
        return (len(ent[0]) if ent else 0) + (len(rel[0]) if rel else 0)
