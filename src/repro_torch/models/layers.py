"""Primitive layers: norms, linear, embedding, RoPE, MLP — the port of the
JAX package's ``models/layers.py`` as ``nn.Module``s and functions.

Parameters are stored in ``cfg.dtype`` (``float32`` on the serving path);
norms and the tied unembedding accumulate in fp32, as ``apply_norm`` and
``unembed`` do in the JAX package. ``Linear`` keeps PyTorch's
``(d_out, d_in)`` weight: the JAX package's ``(d_in, d_out)`` matrices are
transposed once, by ``models.model.lm_params_from_numpy``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.sharding import cores

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unknown dtype {cfg.dtype!r} ({'|'.join(_DTYPES)})") from None


# ---------------------------------------------------------------- norms
class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ms = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


def make_norm(d: int, norm: str, eps: float, *, device=None, dtype=None) -> nn.Module:
    if norm == "rmsnorm":
        return RMSNorm(d, eps, device=device, dtype=dtype)
    if norm == "layernorm":
        return LayerNorm(d, eps, device=device, dtype=dtype)
    raise ValueError(f"unknown norm {norm!r} (rmsnorm|layernorm)")


# ---------------------------------------------------------------- linear
class Linear(nn.Module):
    """``y = x @ W.T + b`` with ``W`` (d_out, d_in), initialised as the JAX
    package's ``init_linear``: N(0, 1) / sqrt(d_in), zero bias."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        d_in = self.weight.shape[1]
        normal_(self.weight, generator, 1.0 / math.sqrt(d_in))
        if self.bias is not None:
            self.bias.zero_()


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``t`` with N(0, 1)·scale drawn in fp32 from ``generator`` and
    rounded once to ``t``'s dtype, as the JAX package's inits do."""
    w = torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32)
    return t.copy_(w * scale)


# ---------------------------------------------------------------- embedding
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, d, device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if isinstance(self.weight, DTensor):
            return cores.embedding(ids, self.weight)
        return F.embedding(ids, self.weight)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.weight, generator, 0.02)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding ``x @ table.T`` → fp32 logits."""
    return x.float() @ table.float().T


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)`` in fp32. ``theta`` stays a Python scalar:
    a tensor made from it on the card would be a host-to-device copy, which
    waits for the stream, in every layer of every decode step."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs          # (..., S, Dh/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)  # (S, d)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU (``act="silu"``: ``down(silu(gate(x)) · up(x))``) or a plain
    gelu MLP (tanh approximation, ``jax.nn.gelu``'s default)."""

    def __init__(self, d: int, d_ff: int, act: str, *, bias: bool = False, device=None,
                 dtype=None):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown act {act!r}")
        self.act = act
        self.up = Linear(d, d_ff, bias=bias, device=device, dtype=dtype)
        self.down = Linear(d_ff, d, bias=bias, device=device, dtype=dtype)
        self.gate = Linear(d, d_ff, bias=bias, device=device, dtype=dtype) if act == "silu" \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.up(x)
        if self.gate is not None:
            h = F.silu(self.gate(x)) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return self.down(h)
