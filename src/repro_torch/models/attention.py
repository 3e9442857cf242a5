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
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import Linear, RMSNorm, apply_rope
from repro_torch.sharding import cores

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, dh)


def attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid: Optional[torch.Tensor] = None, groups=()) -> torch.Tensor:
    """One query per row, q (B, 1, H, Dh), against keys and values (B, T,
    KV, Dh) → the context (B, 1, H, Dh); ``valid`` (B, T) masks keys. Under
    a mesh whose ranks hold slices of the sequence, ``groups`` are the
    process groups over those slices and the softmax is combined over
    them (a max, the exp-sums and the weighted values, all-reduced)."""
    b, _, h, dh = q.shape
    n_kv = k.shape[2]
    qg = q.float().reshape(b, 1, n_kv, h // n_kv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(dh)
    if valid is not None:
        scores = scores.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    if not groups:
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
        return o.reshape(b, 1, h, dh).to(q.dtype)

    def over_groups(t, op):
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
        return t

    mx = over_groups(scores.amax(-1, keepdim=True), "max")
    p = torch.exp(scores - mx)
    den = over_groups(p.sum(-1, keepdim=True), "sum")
    o = over_groups(torch.einsum("bkgst,btkd->bskgd", p, v.float()), "sum")
    o = o / den.permute(0, 3, 1, 2, 4)
    return o.reshape(b, 1, h, dh).to(q.dtype)


def decode_one(q: torch.Tensor, k1: torch.Tensor, v1: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, pos: torch.Tensor, window: int, *, lo: int = 0,
               groups=()) -> torch.Tensor:
    """One token per row: q (B, 1, H, Dh), k1/v1 (B, 1, KV, Dh), written into
    the cache ck/cv (B, T, KV, Dh) at each row's ``pos`` (B,), then keys
    ``t ≤ pos`` (within the window) attended → (B, 1, H, Dh). Under a mesh
    the cache is this rank's slice of the sequence from position ``lo``
    (``groups`` as in ``attend_one``) and a row writes only where its
    position falls inside it."""
    t = ck.shape[1]
    r = torch.arange(q.shape[0], device=q.device)
    if groups:
        local = pos - lo
        mine = ((local >= 0) & (local < t))[:, None, None]
        idx = local.clamp(0, t - 1)
        ck[r, idx] = torch.where(mine, k1[:, 0].to(ck.dtype), ck[r, idx])
        cv[r, idx] = torch.where(mine, v1[:, 0].to(cv.dtype), cv[r, idx])
    else:
        ck[r, pos] = k1[:, 0].to(ck.dtype)
        cv[r, pos] = v1[:, 0].to(cv.dtype)
    ti = lo + torch.arange(t, device=q.device)[None, :]
    valid = ti <= pos[:, None]
    if window:
        valid &= (pos[:, None] - ti) < window
    return attend_one(q, ck, cv, valid, groups)


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
        split = cores.split_heads if isinstance(x, DTensor) else _split_heads
        q = split(self.wq(x), cfg.num_heads, cfg.head_dim)
        k = split(self.wk(src), cfg.num_kv_heads, cfg.head_dim)
        v = split(self.wv(src), cfg.num_kv_heads, cfg.head_dim)
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
        window = self.cfg.sliding_window if causal else 0
        if isinstance(q, DTensor):
            return cores.flash(q, k, v, causal=causal, window=window).reshape(b, s, -1)
        ctx = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
            window=window)
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
        split = cores.split_heads if isinstance(x, DTensor) else _split_heads
        q = split(self.wq(x), cfg.num_heads, cfg.head_dim)
        if isinstance(x, DTensor):
            ctx = cores.attend_memory(attend_one, q, memory)
        else:
            ctx = attend_one(q, memory["k"], memory["v"])
        return self.wo(ctx.reshape(x.shape[0], 1, -1))

    def prefill(self, x: torch.Tensor, cache: dict) -> torch.Tensor:
        """Causal attention over x (B, S, d) that also writes K/V into the
        cache prefix ``[0, S)``."""
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = self._qkv(x, positions)
        y = self.wo(self._flash(q, k, v, causal=True))
        if isinstance(x, DTensor):
            cores.write_prefix(cache["k"], k)
            cores.write_prefix(cache["v"], v)
            return y
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
        if isinstance(x, DTensor):
            ctx = cores.decode(decode_one, q, k1, v1, cache, pos, cfg.sliding_window)
        else:
            ctx = decode_one(q, k1, v1, cache["k"], cache["v"], pos, cfg.sliding_window)
        return self.wo(ctx.reshape(b, 1, -1))
