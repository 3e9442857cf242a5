"""Measured-leakage attacks against the PPAT message surface: the JAX
package's ``core/attacks.py`` (numpy loops there), vectorised here on
tensors in float64 on their device.

  * :func:`membership_inference` — does a released embedding set reveal
    whether a triple was in the client's training data? The attacker fits
    per-relation translation offsets from background triples, then scores
    candidate triples by TransE plausibility under the released rows. AUC
    0.5 = no leakage; 1.0 = full membership disclosure.
  * :func:`reconstruction_attack` — how much of the client's private
    geometry survives the release? Fit the best orthogonal map (procrustes)
    from released to true rows and report the residual alignment.

The results equal the JAX package's: AUC exactly (tie-averaged ranks are
half-integers, exact in float64), the scores and the procrustes fit within
float64 rounding of its order of summation.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

F64 = torch.float64


def _device_of(device, *inputs) -> torch.device:
    """``device`` when given; else the first tensor input's device; else
    (arrays only) the current CUDA card, or an error without one."""
    if device is None:
        for a in inputs:
            if torch.is_tensor(a):
                return a.device
    return resolve_device(device)


def _as_f64(a, device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.float64))
    return t.to(device=device, dtype=F64)


def auc(pos, neg, *, device=None) -> float:
    """Area under the ROC curve for scores ``pos`` (should rank high) vs
    ``neg``: the Mann-Whitney U statistic with tie-averaged ranks. Runs on
    ``device`` (default: the first tensor input's device; for arrays, the
    current CUDA card, or an error without one)."""
    device = _device_of(device, pos, neg)
    pos = _as_f64(pos, device).ravel()
    neg = _as_f64(neg, device).ravel()
    if pos.numel() == 0 or neg.numel() == 0:
        return 0.5
    both = torch.cat([pos, neg])
    vals, order = torch.sort(both, stable=True)
    n = both.numel()
    # a tie group's positions i..j in sorted order share rank (i + j) / 2 + 1
    start = torch.ones(n, dtype=torch.bool, device=both.device)
    start[1:] = vals[1:] != vals[:-1]
    gid = torch.cumsum(start.long(), 0) - 1
    first = torch.nonzero(start).ravel()
    last = torch.cat([first[1:], first.new_tensor([n])]) - 1
    ranks = torch.empty_like(both)
    ranks[order] = (0.5 * (first + last).to(F64) + 1.0)[gid]
    npos = pos.numel()
    u = float(ranks[:npos].sum()) - npos * (npos + 1) / 2.0
    return u / (npos * neg.numel())


def advantage(auc_value: float) -> float:
    """Membership advantage |2·AUC − 1| ∈ [0, 1]."""
    return abs(2.0 * float(auc_value) - 1.0)


def _released_table(released_ent: Dict[int, object], device):
    """(sorted ids, their rows (n, d) float64) on ``device``."""
    ids = sorted(int(k) for k in released_ent)
    rows = torch.stack([_as_f64(released_ent[i], device) for i in ids])
    return torch.as_tensor(ids, dtype=torch.int64, device=device), rows


def _lookup(ids: torch.Tensor, q: torch.Tensor):
    """(row index, found) of each id of ``q`` in the sorted ``ids``."""
    pos = torch.searchsorted(ids, q.contiguous()).clamp(max=max(ids.numel() - 1, 0))
    return pos, ids[pos] == q


def _relation_offsets(ids, rows, triples):
    """Per-relation translation r̂ = mean(e_t − e_h) over the background
    triples whose endpoints are both released: (offsets (R, d), has (R,))."""
    h, r, t = triples.unbind(1)
    ph, fh = _lookup(ids, h)
    pt, ft = _lookup(ids, t)
    ok = fh & ft
    r, d = r[ok], rows[pt[ok]] - rows[ph[ok]]
    n_rel = int(r.max()) + 1 if r.numel() else 0
    sums = torch.zeros(n_rel, rows.shape[1], dtype=F64, device=rows.device)
    counts = torch.zeros(n_rel, dtype=F64, device=rows.device)
    sums.index_add_(0, r, d)
    counts.index_add_(0, r, torch.ones_like(r, dtype=F64))
    return sums / counts.clamp(min=1.0)[:, None], counts > 0


def _score_triples(ids, rows, offsets, has, triples) -> torch.Tensor:
    """TransE plausibility −‖e_h + r̂ − e_t‖ of each scoreable triple, in
    triple order; triples with an unreleased endpoint or an unfitted
    relation are skipped."""
    h, r, t = triples.unbind(1)
    ph, fh = _lookup(ids, h)
    pt, ft = _lookup(ids, t)
    fr = (r >= 0) & (r < has.numel())
    fr[fr.clone()] = has[r[fr]]
    ok = fh & ft & fr
    diff = rows[ph[ok]] + offsets[r[ok]] - rows[pt[ok]]
    return -torch.linalg.vector_norm(diff, dim=1)


def membership_inference(
    released_ent: Dict[int, object],
    member_triples,
    nonmember_triples,
    background_triples=None,
    *,
    device=None,
) -> Dict[str, float]:
    """Membership-inference attack against a DP embedding release.

    ``released_ent`` maps client-local entity id → released row (arrays or
    tensors); ``member_triples`` are true training triples,
    ``nonmember_triples`` held-out ones over the same entities,
    ``background_triples`` the attacker's prior knowledge (default: the
    member set). Runs on ``device`` (default: the first released row's
    device when it is a tensor; for arrays, the current CUDA card, or an
    error without one). Returns ``auc``, ``advantage`` and the scoreable
    counts."""
    if background_triples is None:
        background_triples = member_triples
    device = _device_of(device, next(iter(released_ent.values()), None))
    if not released_ent:
        return {"auc": 0.5, "advantage": 0.0, "n_member": 0, "n_nonmember": 0}
    ids, rows = _released_table(released_ent, device)

    def tri(a):
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a, np.int64))
        return t.to(device=device, dtype=torch.int64).reshape(-1, 3)

    offsets, has = _relation_offsets(ids, rows, tri(background_triples))
    pos = _score_triples(ids, rows, offsets, has, tri(member_triples))
    neg = _score_triples(ids, rows, offsets, has, tri(nonmember_triples))
    a = auc(pos, neg)
    return {"auc": a, "advantage": advantage(a), "n_member": int(pos.numel()),
            "n_nonmember": int(neg.numel())}


def reconstruction_attack(released, true, *, device=None) -> Dict[str, float]:
    """Embedding-reconstruction attack: fit the best orthogonal map from
    released rows to the true private rows (SVD procrustes) and report the
    mean per-row cosine and the MSE after the fit. Runs on ``device``
    (default: the first tensor input's device; for arrays, the current CUDA
    card, or an error without one)."""
    device = _device_of(device, released, true)
    released = _as_f64(released, device)
    true = _as_f64(true, device)
    if released.shape != true.shape or released.numel() == 0:
        raise ValueError(f"released {tuple(released.shape)} and true {tuple(true.shape)} rows "
                         "must match and be non-empty")
    u, _, vt = torch.linalg.svd(released.T @ true)
    rec = released @ (u @ vt)
    num = (rec * true).sum(1)
    den = torch.linalg.vector_norm(rec, dim=1) * torch.linalg.vector_norm(true, dim=1) + 1e-12
    return {"cosine": float((num / den).mean()), "mse": float(((rec - true) ** 2).mean())}
