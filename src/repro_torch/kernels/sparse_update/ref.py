"""Dense autograd oracle of the fused sparse SGD step — tests only."""
from __future__ import annotations

import torch

from repro_torch.kernels.triple_score.ops import sqrt_rn


def _scores(ent, rel, tri, mode):
    he, re, te = ent[tri[:, 0]], rel[tri[:, 1]], ent[tri[:, 2]]
    if mode == "dot":
        return (he * re * te).sum(-1)
    d = he + re - te
    if mode == "l2":
        return -sqrt_rn((d * d).sum(-1) + 1e-12)
    return -d.abs().sum(-1)


def sparse_step_ref(ent, rel, pos, neg, lr, *, mode="l1", margin=4.0):
    """Dense margin-ranking SGD step on {ent, rel} → (new_ent, new_rel,
    loss); the inputs are left as they were."""
    e = ent.detach().float().clone().requires_grad_(True)
    r = rel.detach().float().clone().requires_grad_(True)
    with torch.enable_grad():
        sp = _scores(e, r, pos, mode)
        sn = _scores(e, r, neg, mode)
        loss = torch.relu(margin - sp + sn).mean()
        ge, gr = torch.autograd.grad(loss, (e, r))
    with torch.no_grad():
        return e - lr * ge, r - lr * gr, loss.detach()
