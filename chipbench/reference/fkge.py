"""Plain reference of one FKGE handshake entry (§3.2, Alg. 1 and 2), and of
the triple-classification score that the backtrack decides on.

Given the host's and the client's tables at the tick's start and the
handshake's draws (the discriminators' init, per round the batch ids and the
vote's Laplace noise, the retrain's epoch draws), it works out again what
the port derives: PPAT's adversarial rounds with the PATE vote (Eqs. 3–7),
the moments accountant's ε (Eqs. 8–10), the Procrustes refine, the KGEmb
average of the aligned rows, the virtual extension G(N(X)) with its
adjacency triples, one retrain epoch over the extended store, and the
backtrack's score of the result. Plain PyTorch and NumPy; nothing of the port
is imported. ``dtype`` runs PPAT in a lower precision (the control).

PPAT pads the aligned rows with zero rows to a multiple of 64 and W starts at
the identity, as the paper's MUSE-style translation does; the zero rows are
never sampled and add nothing to the Procrustes product.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from chipbench.reference import kge

PAD_ROWS = 64


# ------------------------------------------------------------------ PPAT
def _leaky(x):
    return torch.where(x >= 0, x, 0.2 * x)


def _prob(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = _leaky(x @ p["w1"] + p["b1"].unsqueeze(-2))
    return torch.sigmoid((h @ p["w2"] + p["b2"].unsqueeze(-2))[..., 0])


def _momentum(p, grads, vel, lr, mom):
    vel = {k: mom * vel[k] + g for k, g in zip(p, grads)}
    return {k: p[k] - lr * vel[k] for k in p}, vel


def _leaves(p):
    return {k: v.detach().requires_grad_(True) for k, v in p.items()}


def ppat(x: torch.Tensor, y: torch.Tensor, cfg: dict, draws: dict,
         dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All adversarial rounds between client rows ``x`` and host rows ``y``
    → (W, clean votes n0, n1, each (steps, batch))."""
    lr, mom, t = cfg["lr"], cfg["momentum"], cfg["num_teachers"]
    x, y = x.to(dtype), y.to(dtype)
    teach = {k: v.to(dtype) for k, v in draws["teachers"].items()}
    stud = {k: v.to(dtype) for k, v in draws["student"].items()}
    tvel = {k: torch.zeros_like(v) for k, v in teach.items()}
    svel = {k: torch.zeros_like(v) for k, v in stud.items()}
    d = x.shape[1]
    w = torch.eye(d, dtype=dtype, device=x.device)
    wvel = torch.zeros_like(w)
    n0s, n1s = [], []
    for s in range(cfg["steps"]):
        xb = x[draws["idx"][s]]
        adv = (xb @ w).detach()
        real = y[draws["ridx"][s]]
        b = adv.shape[0]
        per = b // t
        with torch.enable_grad():
            tp = _leaves(teach)
            pf = _prob(tp, adv[: per * t].reshape(t, per, d))
            pr = _prob(tp, real[: per * t].reshape(t, per, d))
            losses = -(torch.log(1 - pf + 1e-8).mean(-1) + torch.log(pr + 1e-8).mean(-1))
            grads = torch.autograd.grad(losses.sum(), list(tp.values()))
        with torch.no_grad():
            teach, tvel = _momentum(teach, grads, tvel, lr, mom)
            votes = (_prob(teach, adv) >= 0.5).to(torch.int32)
            n1 = votes.sum(0, dtype=torch.int32)
            n0 = t - n1
            noise = draws["noise"][s].float() * (1.0 / cfg["lam"])
            labels = ((n1.float() + noise[1]) > (n0.float() + noise[0])).to(dtype)
        with torch.enable_grad():
            sp = _leaves(stud)
            ps = _prob(sp, adv)
            s_loss = -torch.mean(labels * torch.log(ps + 1e-8)
                                 + (1 - labels) * torch.log(1 - ps + 1e-8))
            grads = torch.autograd.grad(s_loss, list(sp.values()))
        with torch.no_grad():
            stud, svel = _momentum(stud, grads, svel, lr, mom)
        with torch.enable_grad():
            a = adv.clone().requires_grad_(True)
            g_loss = -torch.mean(torch.log(_prob(stud, a) + 1e-8))
            (g_adv,) = torch.autograd.grad(g_loss, a)
        with torch.no_grad():
            wvel = mom * wvel + xb.T @ g_adv
            w = w - lr * wvel
            beta = cfg["ortho_beta"]
            w = (1 + beta) * w - beta * (w @ w.T) @ w
        n0s.append(n0)
        n1s.append(n1)
    return w, torch.stack(n0s), torch.stack(n1s)


def epsilon(n0: np.ndarray, n1: np.ndarray, lam: float, delta: float,
            max_moment: int = 32) -> float:
    """ε̂ = min_l (α(l) + log 1/δ)/l over the clean vote counts (Eqs. 8–10):
    per query the data-dependent moment bound where PATE's theorems allow
    it, else the data-independent 2λ²l(l+1)."""
    ls = np.arange(1, max_moment + 1, dtype=np.float64)
    gap = np.abs(np.asarray(n0, np.float64).ravel() - np.asarray(n1, np.float64).ravel())
    q = (2.0 + lam * gap) / (4.0 * np.exp(lam * gap))
    indep = 2.0 * lam ** 2 * ls * (ls + 1.0)
    denom = 1.0 - np.exp(2.0 * lam) * q
    ok = (q < 1.0 / (1.0 + np.exp(2.0 * lam))) & (denom > 0)
    with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
        ratio = (1.0 - q) / np.where(ok, denom, 1.0)
        term = (1.0 - q)[:, None] * ratio[:, None] ** ls[None, :] \
            + q[:, None] * np.exp(2.0 * lam * ls)[None, :]
        dep = np.log(np.maximum(term, 1e-300))
    bound = np.where(ok[:, None], np.minimum(indep[None, :], np.maximum(dep, 0.0)),
                     indep[None, :])
    alpha = bound.sum(axis=0)
    return float(np.min((alpha + np.log(1.0 / delta)) / ls))


def pad_rows(a: torch.Tensor, mult: int = PAD_ROWS) -> torch.Tensor:
    n = a.shape[0]
    n_pad = max(mult, -(-n // mult) * mult)
    return torch.cat([a, a.new_zeros((n_pad - n, *a.shape[1:]))])


def procrustes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The orthogonal R minimising ‖aR − b‖_F: the polar factor of aᵀb."""
    u, _, vt = torch.linalg.svd(a.T @ b, full_matrices=False)
    return u @ vt


# ------------------------------------------------------ virtual extension
def virtual_structure(client_train: np.ndarray, idx_c: np.ndarray, idx_h: np.ndarray,
                      e0: int, r0: int, max_neighbors: int):
    """N(X): the client's triples with exactly one aligned end (tail-aligned
    ones first, then head-aligned, each in store order, cut to
    ``max_neighbors``), their other ends and relations as virtual rows
    numbered from ``e0``/``r0``, and the adjacency triples in the host's id
    space → (neighbors, relations, extra triples) or None."""
    tri = np.asarray(client_train, np.int64)
    aligned = np.unique(np.asarray(idx_c, np.int64))
    at_t, at_h = np.isin(tri[:, 2], aligned), np.isin(tri[:, 0], aligned)
    tail_side, head_side = tri[at_t & ~at_h], tri[at_h & ~at_t]
    rows = np.concatenate([
        np.stack([tail_side[:, 0], tail_side[:, 1], tail_side[:, 2],
                  np.zeros(len(tail_side), np.int64)], 1),
        np.stack([head_side[:, 2], head_side[:, 1], head_side[:, 0],
                  np.ones(len(head_side), np.int64)], 1)])[:max_neighbors]
    if len(rows) == 0:
        return None
    neigh, rels = np.unique(rows[:, 0]), np.unique(rows[:, 1])
    to_host = dict(zip(np.asarray(idx_c, np.int64).tolist(), np.asarray(idx_h, np.int64).tolist()))
    vn = e0 + np.searchsorted(neigh, rows[:, 0])
    vr = r0 + np.searchsorted(rels, rows[:, 1])
    ha = np.array([to_host[int(a)] for a in rows[:, 2]], np.int64)
    tail_aligned = rows[:, 3] == 0
    extra = np.stack([np.where(tail_aligned, vn, ha), vr, np.where(tail_aligned, ha, vn)], 1)
    return neigh, rels, extra


# ------------------------------------------------------------ the backtrack
def fixed_negatives(valid: np.ndarray, num_entities: int) -> np.ndarray:
    """The backtrack's fixed 1:1 negatives of the valid split: each triple's
    head or tail (by a fair coin) replaced by a uniform entity, from NumPy's
    ``default_rng(0)``, the same negatives for every score."""
    rng = np.random.default_rng(0)
    neg = np.array(valid, copy=True)
    head = rng.random(len(neg)) < 0.5
    ent = rng.integers(0, num_entities, len(neg))
    neg[head, 0] = ent[head]
    neg[~head, 2] = ent[~head]
    return neg


def classification_accuracy(ent: torch.Tensor, rel: torch.Tensor, valid: np.ndarray,
                            neg: np.ndarray, max_candidates: int = 256) -> float:
    """Triple classification (the backtrack's score): the best, over up to
    ``max_candidates`` thresholds taken evenly from the sorted distinct
    scores, of the mean of the share of valid triples scoring at or above
    it and the share of negatives below it; score ``−‖h + r − t‖₁``."""
    def score(t):
        t = torch.as_tensor(np.asarray(t, np.int64), device=ent.device)
        return (-(ent[t[:, 0]] + rel[t[:, 1]] - ent[t[:, 2]]).abs().sum(1)).float().cpu().numpy()


    pos, ng = score(valid), score(neg)
    cand = np.unique(np.concatenate([pos, ng]))
    if len(cand) > max_candidates:
        cand = cand[:: len(cand) // max_candidates]
    acc = ((pos[None, :] >= cand[:, None]).mean(1) + (ng[None, :] < cand[:, None]).mean(1)) / 2
    return float(acc.max())
