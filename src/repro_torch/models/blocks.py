"""Decoder layers and the layer-kind layout — the port of the JAX package's
``models/blocks.py``.

Every layer of an architecture is described by a ``LayerKind`` (mixer ×
ffn). The JAX package stacks the parameters ``repeats × period`` and scans
over the repeats; here the layers are an ``nn.ModuleList`` and layer ``i``
has the kind of period position ``i % period`` (``layout`` is kept so the
weight loader can find repeat ``i // period``).

This slice carries attention and Mamba2 mixers with a dense or no FFN. A MoE
FFN (mixtral, kimi, jamba) and cross-attention (whisper) raise
``NotImplementedError`` and wait for their slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.layers import MLP, make_norm
from repro_torch.models.ssm import Mamba2Mixer, init_ssm_cache


@dataclass(frozen=True)
class LayerKind:
    mixer: str  # "attn" | "ssm"
    ffn: str    # "dense" | "moe" | "none"
    cross: bool = False  # enc-dec decoder layers carry a cross-attention


def layer_kinds(cfg) -> List[LayerKind]:
    kinds = []
    for i in range(cfg.num_layers):
        mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
        if cfg.is_moe_layer(i):
            ffn = "moe"
        elif cfg.d_ff:
            ffn = "dense"
        else:
            ffn = "none"
        kinds.append(LayerKind(mixer, ffn, cross=cfg.arch_type == "encdec"))
    return kinds


def layout(cfg) -> Tuple[int, int, List[LayerKind]]:
    """→ (repeats, period, kinds-of-one-period)."""
    kinds = layer_kinds(cfg)
    n = len(kinds)
    for period in range(1, n + 1):
        if n % period:
            continue
        if all(kinds[i] == kinds[i % period] for i in range(n)):
            return n // period, period, kinds[:period]
    return 1, n, kinds


class DecoderLayer(nn.Module):
    """Pre-norm residual layer: ``h + mixer(norm(h))``, then ``h +
    mlp(norm(h))`` when the FFN is dense."""

    def __init__(self, cfg, kind: LayerKind, *, device=None, dtype=None):
        super().__init__()
        if kind.cross:
            raise NotImplementedError(
                "cross-attention layers (whisper) wait for the encoder-decoder slice")
        if kind.ffn == "moe":
            raise NotImplementedError(
                "MoE FFN layers (mixtral, kimi, jamba) wait for the MoE slice")
        self.cfg = cfg
        self.kind = kind
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.norm_mixer = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw) if kind.mixer == "attn" else None
        self.ssm = Mamba2Mixer(cfg, **kw) if kind.mixer == "ssm" else None
        self.norm_ffn = self.mlp = None
        if kind.ffn == "dense":
            self.norm_ffn = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
            self.mlp = MLP(d, cfg.d_ff, cfg.act, bias=cfg.qkv_bias, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the mixer's weights, then the MLP's (norms stay ones)."""
        (self.attn or self.ssm).reset_parameters(generator)
        if self.mlp is not None:
            for lin in (self.mlp.up, self.mlp.down, self.mlp.gate):
                if lin is not None:
                    lin.reset_parameters(generator)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.mlp is None:
            return h
        return h + self.mlp(self.norm_ffn(h))

    def forward(self, h: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                causal: bool = True) -> torch.Tensor:
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn(x, positions=positions, causal=causal)
        else:
            y, _ = self.ssm(x)
        return self._ffn(h + y)

    def prefill(self, h: torch.Tensor, cache: dict) -> torch.Tensor:
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn.prefill(x, cache["kv"])
        else:
            y = self.ssm.prefill(x, cache["ssm"])
        return self._ffn(h + y)

    def decode(self, h: torch.Tensor, cache: dict, pos: torch.Tensor) -> torch.Tensor:
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn.decode(x, cache["kv"], pos)
        else:
            y = self.ssm.decode(x, cache["ssm"])
        return self._ffn(h + y)


def init_layer_cache(cfg, kind: LayerKind, batch: int, cache_len: int, dtype,
                     device=None) -> dict:
    if kind.mixer == "attn":
        return {"kv": init_kv_cache(cfg, batch, cache_len, dtype, device)}
    return {"ssm": init_ssm_cache(cfg, batch, dtype, device)}
