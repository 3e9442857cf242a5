"""Grouped-query attention with qk-norm, QKV bias, RoPE and a sliding
window: the full-sequence pass, prefill into a KV cache, and one-token
decode with per-slot positions — the port of the JAX package's
``models/attention.py``.

Full-sequence attention and prefill go through the flash-attention kernel
(``kernels/flash_attention``). The JAX package computes the same function
there as dense jnp softmax (and an XLA scan above 8,192 tokens) and never
calls its own Pallas kernel; the tests hold both paths against each other.
Decode stays plain PyTorch, as the JAX decode is plain jnp.

KV caches are dicts ``{"k", "v"}`` of (B, T, KV, Dh) tensors that prefill
and decode update in place (the JAX functions return new arrays).

Cross-attention (whisper's decoder, ``cross=True``: no qk-norm, no RoPE)
takes K and V from the encoder output ``kv_x`` (T = ``encoder_seq`` ≠ S)
through the same kernel, non-causal and without a window. Prefill writes the
encoder's K/V once into the layer's ``cross_kv`` cache, and decode attends
all of it in plain PyTorch, as the JAX ``decode_attention(kv_memory=...)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import Linear, RMSNorm, apply_rope

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, dh)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q: (B, S, H, Dh), k: (B, T, KV, Dh) → scores (B, KV, G, S, T) fp32."""
    b, s, h, dh = q.shape
    qg = q.reshape(b, s, n_kv, h // n_kv, dh)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, KV, G, S, T), v: (B, T, KV, Dh) → (B, S, H·Dh)."""
    b, kv, g, s, _ = probs.shape
    o = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return o.reshape(b, s, kv * g * v.shape[-1])


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device=None) -> dict:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Attention(nn.Module):
    def __init__(self, cfg, *, cross: bool = False, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        kw = dict(bias=cfg.qkv_bias, device=device, dtype=dtype)
        self.wq = Linear(d, cfg.q_dim, **kw)
        self.wk = Linear(d, cfg.kv_dim, **kw)
        self.wv = Linear(d, cfg.kv_dim, **kw)
        self.wo = Linear(cfg.q_dim, d, **kw)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm and not cross:
            self.q_norm = RMSNorm(cfg.head_dim, cfg.norm_eps, device=device, dtype=dtype)
            self.k_norm = RMSNorm(cfg.head_dim, cfg.norm_eps, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.reset_parameters(generator)

    def _qkv(self, x: torch.Tensor, positions: Optional[torch.Tensor],
             kv_x: Optional[torch.Tensor] = None):
        """(q (B, S, H, Dh), k, v (B, T, KV, Dh)) with qk-norm, and RoPE at
        ``positions`` unless K and V come from ``kv_x``."""
        cfg = self.cfg
        src = x if kv_x is None else kv_x
        q = _split_heads(self.wq(x), cfg.num_heads, cfg.head_dim)
        k = _split_heads(self.wk(src), cfg.num_kv_heads, cfg.head_dim)
        v = _split_heads(self.wv(src), cfg.num_kv_heads, cfg.head_dim)
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if kv_x is None and cfg.rope_theta > 0:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _flash(self, q, k, v, *, causal: bool) -> torch.Tensor:
        """(B, S, H, Dh) projections → (B, S, H·Dh) context through the
        flash-attention kernel; the transposes are views."""
        b, s = q.shape[:2]
        ctx = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
            window=self.cfg.sliding_window if causal else 0)
        return ctx.transpose(1, 2).reshape(b, s, -1)

    def forward(self, x: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                causal: bool = True, kv_x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence attention (train / prefill / encoder / cross). x:
        (B, S, d); with ``kv_x`` (B, T, d), K and V come from it and the
        attention is non-causal."""
        if kv_x is None and positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q, k, v = self._qkv(x, positions, kv_x)
        return self.wo(self._flash(q, k, v, causal=causal and kv_x is None))

    def prefill_cross(self, x: torch.Tensor, kv_x: torch.Tensor, memory: dict) -> torch.Tensor:
        """Cross-attention over ``kv_x`` that also writes its K/V into
        ``memory`` (B, T, KV, Dh), the cache decode attends."""
        q, k, v = self._qkv(x, None, kv_x)
        memory["k"].copy_(k)
        memory["v"].copy_(v)
        return self.wo(self._flash(q, k, v, causal=False))

    def decode_memory(self, x: torch.Tensor, memory: dict) -> torch.Tensor:
        """One token per row, x (B, 1, d), attending every row of
        ``memory``'s K/V (the encoder's, written by ``prefill_cross``)."""
        cfg = self.cfg
        q = _split_heads(self.wq(x), cfg.num_heads, cfg.head_dim)
        scores = _gqa_scores(q, memory["k"], cfg.num_kv_heads) / math.sqrt(cfg.head_dim)
        return self.wo(_gqa_out(torch.softmax(scores, dim=-1), memory["v"]))

    def prefill(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """Causal attention over x (B, S, d) that also writes K/V into the
        cache prefix ``[0, S)``."""
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = self._qkv(x, positions)
        y = self.wo(self._flash(q, k, v, causal=True))
        cache["k"][:, :s] = k.to(cache["k"].dtype)
        cache["v"][:, :s] = v.to(cache["v"].dtype)
        return y

    def decode(self, x: torch.Tensor, cache: dict, pos: torch.Tensor) -> torch.Tensor:
        """One token per slot: x (B, 1, d), pos (B,) int — each slot's K/V is
        written at its own position, RoPE applied there, and keys ``t ≤
        pos[b]`` (within the window) attended."""
        cfg = self.cfg
        b = x.shape[0]
        pos = pos.to(device=x.device, dtype=torch.long)
        q, k1, v1 = self._qkv(x, pos[:, None])
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, pos] = k1[:, 0].to(cache["k"].dtype)
        cache["v"][rows, pos] = v1[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        ti = torch.arange(k.shape[1], device=x.device)[None, :]
        valid = ti <= pos[:, None]
        if cfg.sliding_window:
            valid &= (pos[:, None] - ti) < cfg.sliding_window
        scores = _gqa_scores(q, k, cfg.num_kv_heads) / math.sqrt(cfg.head_dim)
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return self.wo(_gqa_out(probs, v))
