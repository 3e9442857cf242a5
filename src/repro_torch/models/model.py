"""The decoder-only language model: init, forward, prefill and decode — the
port of the JAX package's ``models/model.py``.

``CausalLM`` holds its layers in an ``nn.ModuleList`` where the JAX package
stacks them ``repeats × period`` and scans; ``lm_params_from_numpy`` carries
the JAX package's parameters across (layer ``i`` is repeat ``i // period``
of period position ``i % period``). Caches are lists of per-layer dicts that
``prefill`` and ``decode_step`` update in place.

This slice serves decoder-only cards with attention and Mamba2 mixers and
dense FFNs (qwen3-0.6b, mamba2-2.7b, qwen2.5, starcoder2, deepseek-coder):
encoder inputs (whisper) and patch inputs (internvl) raise, and so do MoE
layers (``blocks.DecoderLayer``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.blocks import DecoderLayer, init_layer_cache, layout
from repro_torch.models.layers import Embedding, Linear, dtype_of, make_norm, unembed


class CausalLM(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        if cfg.encoder_layers or cfg.learned_pos_emb:
            raise NotImplementedError(
                "encoder inputs and learned positions (whisper) wait for the "
                "encoder-decoder slice")
        if cfg.num_patches:
            raise NotImplementedError("patch inputs (internvl) wait for the VLM slice")
        self.cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype_of(cfg))
        d = cfg.d_model
        _, period, kinds = layout(cfg)
        self.embed = Embedding(cfg.padded_vocab, d, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kinds[i % period], **kw) for i in range(cfg.num_layers))
        self.final_norm = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
        self.unembed = None if cfg.tie_embeddings else Linear(d, cfg.padded_vocab, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    # ------------------------------------------------------------ pieces
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        if self.unembed is None:
            return unembed(self.embed.weight, h)
        return self.unembed(h).float()

    # ------------------------------------------------------------ passes
    def forward(self, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) → logits (B, S, V_pad) fp32."""
        h = self.embed(tokens)
        for layer in self.layers:
            h = layer(h, positions=positions)
        return self._logits(h)

    def init_cache(self, batch: int, cache_len: int, dtype=None) -> List[Dict]:
        dtype = dtype or dtype_of(self.cfg)
        return [init_layer_cache(self.cfg, layer.kind, batch, cache_len, dtype, self.device)
                for layer in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: List[Dict]) -> torch.Tensor:
        """Full forward over tokens (B, S) that fills the cache prefix
        (attention K/V rows ``[0, S)``, SSM state and conv tail) → the last
        position's logits (B, 1, V_pad)."""
        h = self.embed(tokens)
        for layer, c in zip(self.layers, cache):
            h = layer.prefill(h, c)
        return self._logits(h[:, -1:, :])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: List[Dict], pos) -> torch.Tensor:
        """One token per row: token (B, 1), ``pos`` each row's write position
        (an int for all rows, or a (B,) tensor) → logits (B, 1, V_pad)."""
        b = token.shape[0]
        pos = torch.as_tensor(pos, device=token.device, dtype=torch.long)
        if pos.dim() == 0:
            pos = pos.expand(b)
        h = self.embed(token)
        for layer, c in zip(self.layers, cache):
            h = layer.decode(h, c, pos)
        return self._logits(h)


@torch.no_grad()
def init_params(cfg, generator: Optional[torch.Generator] = None, *, device=None) -> CausalLM:
    """A ``CausalLM`` with the JAX package's init laws (embedding N(0, 1)·0.02,
    linears N(0, 1)/sqrt(d_in), zero biases, unit norms, the Mamba2 laws of
    ``ssm.Mamba2Mixer.reset_parameters``), drawn from ``generator`` (default:
    seed 0 on the device). The numbers differ from the JAX package's, whose
    ``jax.random`` draws PyTorch cannot reproduce: carry those across with
    ``lm_params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on {dev}")
    model = CausalLM(cfg, device=dev)
    model.embed.reset_parameters(generator)
    for layer in model.layers:
        layer.reset_parameters(generator)
    if model.unembed is not None:
        model.unembed.reset_parameters(generator)
    return model


#: JAX leaves whose (d_in, d_out) matrix becomes a PyTorch (d_out, d_in) weight
_TRANSPOSED = {"w": "weight", "in_proj": "in_proj.weight", "out_proj": "out_proj.weight"}
_RENAMED = {"b": "bias", "table": "weight"}


def _flatten(tree: dict, prefix: str, pick, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", pick, out)
            continue
        arr = np.asarray(pick(val), dtype=np.float32)
        if key in _TRANSPOSED:
            out[prefix + _TRANSPOSED[key]] = torch.from_numpy(np.ascontiguousarray(arr.T))
        else:
            out[prefix + _RENAMED.get(key, key)] = torch.from_numpy(np.array(arr))


def lm_params_from_numpy(cfg, tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` tree (numpy leaves; each layer
    stack ``(repeats, …)`` per period position) → this port's ``CausalLM``
    state dict (CPU float32 tensors; ``load_state_dict`` casts and moves
    them). Layer ``i`` is repeat ``i // period`` of position ``i % period``."""
    _, period, _ = layout(cfg)
    out: Dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in tree.items() if k != "layers"}, "", lambda v: v, out)
    for i in range(cfg.num_layers):
        r, p = divmod(i, period)
        _flatten(tree["layers"][p], f"layers.{i}.", lambda v, r=r: np.asarray(v)[r], out)
    return out
