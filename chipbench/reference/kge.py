"""Plain references for TransE (L1): the margin-SGD epoch, filtered ranks
and top-k tails. Plain PyTorch over the whole tables, step after step; no
kernel, no padding of the tables, nothing of the port imported. ``dtype``
runs a reference in a lower precision (the control: bfloat16 for this
configuration's float32).

The epoch follows the paper's training (§4.1.1, OpenKE's defaults): each
step takes ``batch`` positives of the permuted store and their corruptions,
the loss is ``mean(relu(margin − s⁺ + s⁻))`` with ``s = −‖h + r − t‖₁``,
every row the step names moves by ``−lr·∂loss/∂row`` (duplicates add), and
after the epoch every entity row is projected onto the unit ball.
|x|'s derivative at 0 is taken as +1.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def padded_store(train: np.ndarray, batch: int, device) -> Tuple[torch.Tensor, int]:
    """The store cycled up to a power-of-two number of ``batch``-triple
    steps (every added row a real triple, in store order) → (store, nb)."""
    tri = torch.as_tensor(np.asarray(train, np.int64), device=device)
    n = tri.shape[0]
    b = min(batch, n)
    nb = 1 << (max(1, -(-n // b)) - 1).bit_length()
    extra = torch.arange(nb * b - n, device=device) % n
    return torch.cat([tri, tri[extra]]), nb


def epoch_batches(store: torch.Tensor, draws, batch: int):
    """(pos, neg), each (nb, batch, 3), from one epoch's draws."""
    perm, corrupt_head, rand_ent = (torch.as_tensor(x, device=store.device) for x in draws)
    nb = store.shape[0] // batch
    pos = store[perm.long()].reshape(nb, batch, 3)
    ch = corrupt_head.bool().reshape(nb, batch)
    re = rand_ent.long().reshape(nb, batch)
    neg = torch.stack([torch.where(ch, re, pos[..., 0]), pos[..., 1],
                       torch.where(ch, pos[..., 2], re)], -1)
    return pos, neg


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def sgd_epoch(ent: torch.Tensor, rel: torch.Tensor, train: np.ndarray, draws, *, lr: float,
              margin: float, batch: int, half_batch: bool = False) -> float:
    """One epoch in place on ``ent`` and ``rel`` (in their dtype) → the
    mean of its step losses. ``half_batch`` is a planted fault: each step
    uses only the first half of its batch and means over it.

    A step is the same few plain operations whatever the step; on a CUDA
    device they are captured once as a graph and replayed step after step
    (the step number lives on the device), only so that the reference's
    launches do not take minutes."""
    store, _ = padded_store(train, batch, ent.device)
    pos, neg = epoch_batches(store, draws, min(batch, len(train)))
    if half_batch:
        keep = max(1, pos.shape[1] // 2)
        pos, neg = pos[:, :keep], neg[:, :keep]
    nb, b = pos.shape[:2]
    d = ent.shape[1]
    # per step: the entity rows (h⁺, t⁺, h⁻, t⁻) and the relation rows (r⁺, r⁻)
    ents = torch.stack([pos[..., 0], pos[..., 2], neg[..., 0], neg[..., 2]], 1).reshape(nb, -1)
    rels = torch.stack([pos[..., 1], neg[..., 1]], 1).reshape(nb, -1)
    losses = torch.zeros(nb, dtype=torch.float32, device=ent.device)
    step = torch.zeros(1, dtype=torch.long, device=ent.device)
    side = torch.tensor([1.0, -1.0], dtype=ent.dtype, device=ent.device).view(2, 1, 1)

    def one_step():
        ei = ents.index_select(0, step).view(-1)
        ri = rels.index_select(0, step).view(-1)
        e = ent.index_select(0, ei).view(4, b, d)
        diff = e[0::2] + rel.index_select(0, ri).view(2, b, d) - e[1::2]   # (h + r − t)⁺, ⁻
        s = -diff.abs().sum(-1)
        viol = margin - s[0] + s[1]
        losses.index_copy_(0, step, torch.relu(viol).float().mean().view(1))
        # ∂loss/∂(h + r − t): +sign/B for the positives, −sign/B for the negatives
        g = _sign(diff) * ((viol > 0).to(ent.dtype) / b).view(1, b, 1) * side
        ent.index_add_(0, ei, torch.stack([g[0], -g[0], g[1], -g[1]]).view(4 * b, d),
                       alpha=-lr)
        rel.index_add_(0, ri, g.reshape(2 * b, d), alpha=-lr)
        step.add_(1)

    warm = min(3, nb)
    if ent.is_cuda:
        side_stream = torch.cuda.Stream(device=ent.device)
        side_stream.wait_stream(torch.cuda.current_stream(ent.device))
        with torch.cuda.stream(side_stream):
            for _ in range(warm):
                one_step()
        torch.cuda.current_stream(ent.device).wait_stream(side_stream)
        if nb > warm:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                one_step()
            for _ in range(nb - warm):
                graph.replay()
            del graph
    else:
        for _ in range(nb):
            one_step()
    norms = ent.float().square().sum(1, keepdim=True).sqrt()
    ent.div_(torch.clamp(norms, min=1.0).to(ent.dtype))
    return float(losses.mean())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = float(np.median(list(ref.values())))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


# --------------------------------------------------------------- serving
def l1_scores(q: torch.Tensor, ent: torch.Tensor, rows: int = 128,
              block: int = 8192) -> torch.Tensor:
    """(B, E) scores −‖q − e‖₁ of every entity, in the tables' dtype, by
    blocks of query rows and entities."""
    out = torch.empty((q.shape[0], ent.shape[0]), dtype=torch.float32, device=q.device)
    for r0 in range(0, q.shape[0], rows):
        qb = q[r0:r0 + rows, None, :]
        for c0 in range(0, ent.shape[0], block):
            out[r0:r0 + rows, c0:c0 + block] = -(qb - ent[None, c0:c0 + block]).abs().sum(-1).float()
    return out


class KnownTails:
    """The known tails of each (h, r), by one sort of the known triples."""

    def __init__(self, known: np.ndarray):
        known = np.asarray(known, np.int64)
        self.span = int(known[:, 1].max()) + 1
        code = known[:, 0] * self.span + known[:, 1]
        order = np.lexsort((known[:, 2], code))
        self.code, self.tail = code[order], known[order, 2]

    def of(self, h: int, r: int) -> np.ndarray:
        c = h * self.span + r
        lo, hi = np.searchsorted(self.code, c, "left"), np.searchsorted(self.code, c, "right")
        return np.unique(self.tail[lo:hi])


def filter_mask(known: KnownTails, h: np.ndarray, r: np.ndarray, e: int, device) -> torch.Tensor:
    """(B, E) bool: the entities a filtered query of each (h, r) leaves out."""
    mask = torch.zeros((len(h), e), dtype=torch.bool, device=device)
    for i, (hh, rr) in enumerate(zip(h, r)):
        ids = known.of(int(hh), int(rr))
        if len(ids):
            mask[i, torch.as_tensor(ids, device=device)] = True
    return mask


def rank_bands(ent: torch.Tensor, rel: torch.Tensor, h, r, t, known: KnownTails,
               tol: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Filtered tail ranks of (h, r, t) as bands (lo, hi): the entities
    outside the filter (the known tails and t itself) that score above the
    gold score by more than the near-tie margin ``tol·(1 + |gold|)``, plus
    one, and the same counting the near ties in."""
    dev = ent.device
    h_t, r_t, t_t = (torch.as_tensor(np.asarray(x, np.int64), device=dev) for x in (h, r, t))
    q = ent[h_t] + rel[r_t]
    s = l1_scores(q, ent)
    gold = -(q - ent[t_t]).abs().sum(1).float()
    excl = filter_mask(known, h, r, ent.shape[0], dev)
    excl[torch.arange(len(t_t), device=dev), t_t] = True
    margin = (tol * (1 + gold.abs()))[:, None]
    lo = ((s > gold[:, None] + margin) & ~excl).sum(1) + 1
    hi = ((s > gold[:, None] - margin) & ~excl).sum(1) + 1
    return lo.cpu().numpy(), hi.cpu().numpy()


def topk(ent: torch.Tensor, rel: torch.Tensor, h, r, k: int, known: KnownTails
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtered top-k tails of (h, r): (scores (B, k) descending, every
    entity's score (B, E) with the known tails at −inf)."""
    dev = ent.device
    h_t, r_t = (torch.as_tensor(np.asarray(x, np.int64), device=dev) for x in (h, r))
    s = l1_scores(ent[h_t] + rel[r_t], ent)
    s.masked_fill_(filter_mask(known, h, r, ent.shape[0], dev), float("-inf"))
    return s.topk(k, dim=1).values, s


def topk_gap(served_ids: np.ndarray, served_scores: np.ndarray, best: torch.Tensor,
             scores: torch.Tensor) -> float:
    """The widest gap, over served positions, by which a served tail's
    reference score lies below the reference's score at that position, or
    by which the served score departs from the reference's score of the
    served tail; each against 1 + |reference score|. A filtered, missing or
    out-of-range tail reads infinity."""
    ids = torch.as_tensor(np.asarray(served_ids, np.int64), device=scores.device)
    if ids.shape != best.shape or bool(((ids < 0) | (ids >= scores.shape[1])).any()):
        return float("inf")
    got = scores.gather(1, ids)
    served = torch.as_tensor(np.asarray(served_scores, np.float32), device=scores.device)
    scale = 1 + best.abs()
    gap = torch.maximum(best - got, (served - got).abs()) / scale
    gap = torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf")))
    return float(gap.max())
