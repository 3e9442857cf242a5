"""The plain PyTorch version of the flash-attention kernel: dense masked
softmax attention over the whole (S, T) score matrix.

It computes what the JAX package's ``flash_attention/ref.py::attention_ref``
computes, with the kernel's conventions: scores are ``(q·k) · scale`` with
``scale = 1/sqrt(Dh)``, masked scores are −1e30, and a query row with no
valid key gives 0 (the dense softmax of the JAX oracle would average every
value row there; such rows occur only when a causal window lies wholly past
``T``). The CPU path of ``ops.flash_attention`` runs this, and the card
checks hold the CUDA kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(s: int, t: int, *, causal: bool, window: int, device=None) -> torch.Tensor:
    """(S, T) bool: key ``k`` is visible to query ``q`` when ``k < T`` and,
    if causal, ``k ≤ q``, and, with a window, ``q − k < window``."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= (qp - kp) < window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int = 0) -> torch.Tensor:
    """q: (B, H, S, Dh); k/v: (B, KV, T, Dh) with H % KV == 0 → (B, H, S, Dh)
    in q's dtype; fp32 math."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, s, dh)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * (1.0 / math.sqrt(dh))
    mask = attention_mask(s, t, causal=causal, window=window, device=q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = probs.masked_fill(~mask.any(1)[:, None], 0.0)  # rows with no valid key → 0
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)
