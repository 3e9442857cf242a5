"""Decoder layers and the layer-kind layout — the port of the JAX package's
``models/blocks.py``.

Every layer of an architecture is described by a ``LayerKind`` (mixer ×
ffn). The JAX package stacks the parameters ``repeats × period`` and scans
over the repeats; here the layers are an ``nn.ModuleList`` and layer ``i``
has the kind of period position ``i % period`` (``layout`` is kept so the
weight loader can find repeat ``i // period``).

A layer is an attention or Mamba2 mixer, then (enc-dec decoder layers) a
cross-attention over the encoder output, then a dense, MoE or no FFN. Every
pass returns the layer's MoE auxiliary loss beside ``h`` (0 without a MoE
FFN), as the JAX ``apply_layer`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.layers import MLP, make_norm
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import Mamba2Mixer, init_ssm_cache
from repro_torch.sharding.context import batch_rows


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
    """Pre-norm residual layer: ``h + mixer(norm(h))``; with ``kind.cross``,
    ``h + cross_attn(norm(h), encoder)``; then ``h + ffn(norm(h))`` for a
    dense or MoE FFN."""

    def __init__(self, cfg, kind: LayerKind, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.norm_mixer = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
        self.attn = Attention(cfg, **kw) if kind.mixer == "attn" else None
        self.ssm = Mamba2Mixer(cfg, **kw) if kind.mixer == "ssm" else None
        self.norm_cross = self.cross_attn = None
        if kind.cross:
            self.norm_cross = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
            self.cross_attn = Attention(cfg, cross=True, **kw)
        self.norm_ffn = self.mlp = self.moe = None
        if kind.ffn != "none":
            self.norm_ffn = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
        if kind.ffn == "dense":
            self.mlp = MLP(d, cfg.d_ff, cfg.act, bias=cfg.qkv_bias, **kw)
        elif kind.ffn == "moe":
            self.moe = MoE(cfg, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the mixer's weights, the cross-attention's, then the FFN's
        (norms stay ones)."""
        (self.attn or self.ssm).reset_parameters(generator)
        if self.cross_attn is not None:
            self.cross_attn.reset_parameters(generator)
        if self.mlp is not None:
            for lin in (self.mlp.up, self.mlp.down, self.mlp.gate):
                if lin is not None:
                    lin.reset_parameters(generator)
        if self.moe is not None:
            self.moe.reset_parameters(generator)

    def _cross(self, h: torch.Tensor, encoder_out: Optional[torch.Tensor]) -> torch.Tensor:
        if self.cross_attn is None or encoder_out is None:
            return h
        return batch_rows(h + self.cross_attn(self.norm_cross(h), kv_x=encoder_out, causal=False))

    def _ffn(self, h: torch.Tensor, moe_groups: str = "joint"):
        """→ (h after the FFN, the MoE aux loss or 0)."""
        if self.mlp is not None:
            return batch_rows(h + self.mlp(self.norm_ffn(h))), h.new_zeros((), dtype=torch.float32)
        if self.moe is not None:
            y, aux = self.moe(self.norm_ffn(h), groups=moe_groups)
            return batch_rows(h + y), aux
        return h, h.new_zeros((), dtype=torch.float32)

    def forward(self, h: torch.Tensor, *, positions: Optional[torch.Tensor] = None,
                causal: bool = True, encoder_out: Optional[torch.Tensor] = None):
        """Full-sequence layer (train / encoder) → (h, aux)."""
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn(x, positions=positions, causal=causal)
        else:
            y, _ = self.ssm(x)
        return self._ffn(self._cross(batch_rows(h + y), encoder_out))

    def prefill(self, h: torch.Tensor, cache: dict,
                encoder_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill that fills this layer's cache; a cross layer also writes
        the encoder's K/V into ``cache["cross_kv"]`` once, for decode."""
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn.prefill(x, cache["kv"])
        else:
            y = self.ssm.prefill(x, cache["ssm"])
        h = batch_rows(h + y)
        if self.cross_attn is not None and encoder_out is not None:
            h = batch_rows(h + self.cross_attn.prefill_cross(self.norm_cross(h), encoder_out,
                                                           cache["cross_kv"]))
        return self._ffn(h)[0]

    def decode(self, h: torch.Tensor, cache: dict, pos: torch.Tensor,
               moe_groups: str = "joint") -> torch.Tensor:
        x = self.norm_mixer(h)
        if self.attn is not None:
            y = self.attn.decode(x, cache["kv"], pos)
        else:
            y = self.ssm.decode(x, cache["ssm"])
        h = batch_rows(h + y)
        if self.cross_attn is not None:
            h = batch_rows(h + self.cross_attn.decode_memory(self.norm_cross(h),
                                                           cache["cross_kv"]))
        return self._ffn(h, moe_groups)[0]


def init_layer_cache(cfg, kind: LayerKind, batch: int, cache_len: int, dtype,
                     device=None) -> dict:
    c = {}
    if kind.mixer == "attn":
        c["kv"] = init_kv_cache(cfg, batch, cache_len, dtype, device)
    else:
        c["ssm"] = init_ssm_cache(cfg, batch, dtype, device)
    if kind.cross:
        c["cross_kv"] = init_kv_cache(cfg, batch, cfg.encoder_seq, dtype, device)
    return c
