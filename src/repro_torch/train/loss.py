"""Cross-entropy loss with optional sequence-chunked logits — the port of the
JAX package's ``train/loss.py``.

``ce_chunk > 0`` never forms the whole (B, S, V) logits: the final hidden
states are cut into sequence chunks, and each chunk's logits and CE run
under ``torch.utils.checkpoint``, so the backward pass recomputes them one
chunk at a time, as the reference's ``jax.checkpoint``-ed scan does. At
qwen3-0.6b's vocabulary (151,936) and a 4 × 2,048 microbatch the whole
logits would be 5 GB in fp32; a 512-token chunk is 1.2 GB.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.models.layers import unembed
from repro_torch.sharding import cores


def _ce_from_logits(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                    z_loss: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, V) fp32, labels (N,), mask (N,) → (sum of the masked NLL,
    z_loss · sum of the masked lse²)."""
    if isinstance(logits, DTensor):
        return cores.cross_entropy(logits, labels, mask, z_loss)
    m = mask.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
    nll = torch.sum((lse - picked) * m)
    z = (torch.sum(torch.square(lse) * m) * z_loss if z_loss
         else logits.new_zeros((), dtype=torch.float32))
    return nll, z


def _project(model, h: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states (N, d) → fp32 logits (N, V_pad)."""
    if model.unembed is None:
        return unembed(model.embed.weight, h)
    return model.unembed(h).float()


def lm_loss(model, cfg, tokens: torch.Tensor, labels: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None, patches: Optional[torch.Tensor] = None,
            ce_chunk: int = 0, z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict]:
    """Mean next-token CE (+ the MoE aux, + the z-loss) of ``model``
    (a ``CausalLM``) → (loss, {"nll", "aux", "z"}), 0-d fp32 tensors.
    Positions whose label is −1 are masked; a VLM's loss covers only the
    token positions, behind its patches."""
    h, aux = model(tokens, frames=frames, patches=patches, return_hidden=True)
    if cfg.num_patches:
        h = h[:, cfg.num_patches:, :]
    b, s, d = h.shape
    mask = labels >= 0
    labels = labels.clamp(min=0)
    denom = torch.clamp(mask.float().sum(), min=1.0)

    if ce_chunk and s % ce_chunk == 0 and s > ce_chunk:
        def chunk_ce(hc, lc, mc):
            logits = _project(model, hc.reshape(-1, d))
            return _ce_from_logits(logits, lc.reshape(-1), mc.reshape(-1), z_loss)

        nll = z = h.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, ce_chunk):
            sl = slice(c0, c0 + ce_chunk)
            n_c, z_c = ckpt.checkpoint(chunk_ce, h[:, sl], labels[:, sl], mask[:, sl],
                                       use_reentrant=False)
            nll, z = nll + n_c, z + z_c
    else:
        nll, z = _ce_from_logits(_project(model, h.reshape(b * s, d)), labels.reshape(-1),
                                 mask.reshape(-1), z_loss)

    loss = nll / denom + z / denom + aux
    return loss, {"nll": nll / denom, "aux": aux, "z": z / denom}
