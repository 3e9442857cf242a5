"""The language model: init, forward, prefill and decode for every card —
the port of the JAX package's ``models/model.py``.

``CausalLM`` holds its layers in an ``nn.ModuleList`` where the JAX package
stacks them ``repeats × period`` and scans; ``lm_params_from_numpy`` carries
the JAX package's parameters across (layer ``i`` is repeat ``i // period``
of period position ``i % period``). Caches are lists of per-layer dicts that
``prefill`` and ``decode_step`` update in place.

Beyond the decoder stack: an encoder-decoder card (whisper) runs an encoder
over stubbed frame embeddings (``frames=``, (B, ``encoder_seq``, d):
``frame_proj``, sinusoidal positions, ``encoder_layers`` non-causal
layers, a final norm) whose output the decoder's cross-attention reads, and
adds learned positions (clamped to the table's last row) to the token
embeddings; a VLM card (internvl) prepends ``patch_proj(patches)``
(``patches=``, (B, ``num_patches``, d)) to them, so prefill fills cache rows
``[0, num_patches + S)``. MoE layers route jointly over a call's tokens,
unless ``decode_step(moe_groups="row")`` asks for one group per row (the
serving engine's slots).

Training (``repro_torch.train``) differentiates ``forward``: with
``cfg.remat`` and grad mode on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), so its activations are
recomputed in the backward pass, as the reference's ``jax.checkpoint`` of
its scan body (one repeat of the period) does; ``remat_policy="dots"``
keeps the outputs of the layer's matrix products (``aten.mm``/``addmm``:
products without batch dimensions, as ``dots_with_no_batch_dims_saveable``)
and recomputes the rest. Without grad (serving) layers run plainly.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.blocks import DecoderLayer, LayerKind, init_layer_cache, layout
from repro_torch.models.layers import (
    Embedding, Linear, dtype_of, make_norm, normal_, sinusoidal_positions, unembed)
from repro_torch.sharding import cores
from repro_torch.sharding.context import batch_rows

ENCODER_KIND = LayerKind("attn", "dense", cross=False)

#: the matrix products that ``remat_policy="dots"`` saves: those without a
#: batch dimension (the reference's ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def run_layer(cfg, layer: nn.Module, h: torch.Tensor, **kw):
    """``layer(h, **kw)`` → (h, aux), under ``torch.utils.checkpoint`` when
    ``cfg.remat`` asks for it and grad mode is on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(h, **kw)
    if cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full|dots)")
    extra = {}
    if cfg.remat_policy == "dots":
        extra["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _dots_policy)
    return ckpt.checkpoint(functools.partial(layer, **kw), h, use_reentrant=False, **extra)


def _project(proj: Linear, x: torch.Tensor) -> torch.Tensor:
    """A frontend stub's projection (frames, patches); under a mesh its
    weight is whole on every rank."""
    if isinstance(x, DTensor):
        return cores.per_rows(F.linear, x, *(t for t in (proj.weight, proj.bias)
                                             if t is not None))
    return proj(x)


class Encoder(nn.Module):
    """Whisper-style encoder over stubbed frame embeddings (B, S_enc, d)."""

    def __init__(self, cfg, **kw):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.frame_proj = Linear(d, d, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, ENCODER_KIND, **kw)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = make_norm(d, cfg.norm, cfg.norm_eps, **kw)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        h = _project(self.frame_proj, frames.to(self.frame_proj.weight.dtype))
        h = h + sinusoidal_positions(frames.shape[1], self.cfg.d_model,
                                     device=h.device).to(h.dtype)[None]
        for layer in self.layers:
            h, _ = run_layer(self.cfg, layer, h, causal=False)
        return self.final_norm(h)


class CausalLM(nn.Module):
    def __init__(self, cfg, *, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=resolve_device(device), dtype=dtype_of(cfg))
        d = cfg.d_model
        _, period, kinds = layout(cfg)
        self.embed = Embedding(cfg.padded_vocab, d, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kinds[i % period], **kw) for i in range(cfg.num_layers))
        self.final_norm = make_norm(d, cfg.norm, cfg.norm_eps, **kw)
        self.unembed = None if cfg.tie_embeddings else Linear(d, cfg.padded_vocab, **kw)
        self.pos_emb = (nn.Parameter(torch.empty(cfg.learned_pos_emb, d, **kw))
                        if cfg.learned_pos_emb else None)
        self.encoder = Encoder(cfg, **kw) if cfg.encoder_layers else None
        self.patch_proj = Linear(d, d, **kw) if cfg.num_patches else None

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    # ------------------------------------------------------------ pieces
    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.final_norm(h)
        if self.unembed is None:
            return unembed(self.embed.weight, h)
        return self.unembed(h).float()

    def _encode(self, frames: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.encoder is None:
            return None
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder card: pass frames= "
                             f"(B, {self.cfg.encoder_seq}, {self.cfg.d_model})")
        return self.encoder(frames)

    def _embed(self, tokens: torch.Tensor, patches: Optional[torch.Tensor] = None,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, plus learned positions (``positions``, default
        ``0..S−1``, clamped to the table), with the projected patches in
        front."""
        h = self.embed(tokens)
        if self.pos_emb is not None:
            if positions is None:
                positions = torch.arange(tokens.shape[1], device=h.device)[None, :]
            positions = positions.clamp(max=self.cfg.learned_pos_emb - 1)
            h = h + self.pos_emb[positions].expand(h.shape)
        if self.patch_proj is not None and patches is not None:
            h = torch.cat([_project(self.patch_proj, patches.to(h.dtype)), h], dim=1)
        return batch_rows(h)

    # ------------------------------------------------------------ passes
    def forward(self, tokens: torch.Tensor, *, frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, return_aux: bool = False,
                return_hidden: bool = False):
        """tokens (B, S) → logits (B, S', V_pad) fp32 (S' = S plus the
        patches), and the layers' summed MoE aux loss with ``return_aux``;
        with ``return_hidden``, (the final-normed hidden states (B, S', d),
        aux) instead, as the reference's ``forward(return_hidden=True)``."""
        encoder_out = self._encode(frames)
        h = self._embed(tokens, patches, positions)
        aux = h.new_zeros((), dtype=torch.float32)
        for layer in self.layers:
            h, a = run_layer(self.cfg, layer, h, positions=positions, encoder_out=encoder_out)
            aux = aux + a
        if return_hidden:
            return self.final_norm(h), aux
        logits = self._logits(h)
        return (logits, aux) if return_aux else logits

    def init_cache(self, batch: int, cache_len: int, dtype=None) -> List[Dict]:
        dtype = dtype or dtype_of(self.cfg)
        return [init_layer_cache(self.cfg, layer.kind, batch, cache_len, dtype, self.device)
                for layer in self.layers]

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: List[Dict], *,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full forward over tokens (B, S) — behind the patches, against the
        encoder's output of the frames — that fills the cache prefix
        (attention K/V rows ``[0, S')``, SSM state and conv tail, the
        encoder's K/V of each cross layer) → the last position's logits
        (B, 1, V_pad)."""
        encoder_out = self._encode(frames)
        h = self._embed(tokens, patches)
        for layer, c in zip(self.layers, cache):
            h = layer.prefill(h, c, encoder_out)
        return self._logits(h[:, -1:, :])

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: List[Dict], pos, *,
                    moe_groups: str = "joint") -> torch.Tensor:
        """One token per row: token (B, 1), ``pos`` each row's write position
        (an int for all rows, or a (B,) tensor) → logits (B, 1, V_pad).
        ``moe_groups="row"`` routes each row's token through the MoE layers
        alone (capacity counted over one token)."""
        b = token.shape[0]
        pos = torch.as_tensor(pos, device=token.device, dtype=torch.long)
        if pos.dim() == 0:
            pos = pos.expand(b)
        h = self._embed(token, positions=pos[:, None])
        for layer, c in zip(self.layers, cache):
            h = layer.decode(h, c, pos, moe_groups)
        return self._logits(h)


@torch.no_grad()
def init_params(cfg, generator: Optional[torch.Generator] = None, *, device=None) -> CausalLM:
    """A ``CausalLM`` with the JAX package's init laws (embedding and learned
    positions N(0, 1)·0.02, linears N(0, 1)/sqrt(d_in), zero biases, unit
    norms, the Mamba2 laws of ``ssm.Mamba2Mixer.reset_parameters``, the MoE
    laws of ``moe.MoE.reset_parameters``), drawn from ``generator`` (default:
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
    if model.pos_emb is not None:
        normal_(model.pos_emb, generator, 0.02)
    if model.encoder is not None:
        model.encoder.frame_proj.reset_parameters(generator)
        for layer in model.encoder.layers:
            layer.reset_parameters(generator)
    if model.patch_proj is not None:
        model.patch_proj.reset_parameters(generator)
    return model


#: JAX leaves whose (d_in, d_out) matrix becomes a PyTorch (d_out, d_in) weight
_TRANSPOSED = {"w": "weight", "in_proj": "in_proj.weight", "out_proj": "out_proj.weight"}
_RENAMED = {"b": "bias", "table": "weight"}


def _f32(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _flatten(tree: dict, prefix: str, pick, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", pick, out)
            continue
        arr = _f32(pick(val))
        if key in _TRANSPOSED:
            out[prefix + _TRANSPOSED[key]] = torch.from_numpy(np.ascontiguousarray(arr.T))
        else:
            out[prefix + _RENAMED.get(key, key)] = torch.from_numpy(np.array(arr))


def lm_params_from_numpy(cfg, tree: dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_params`` tree (numpy leaves; each layer
    stack ``(repeats, …)`` per period position) → this port's ``CausalLM``
    state dict (CPU float32 tensors; ``load_state_dict`` casts and moves
    them). Layer ``i`` is repeat ``i // period`` of position ``i % period``;
    encoder layer ``i`` is repeat ``i`` of the encoder's one stack. Expert
    stacks keep their (E, d, f) layout."""
    _, period, _ = layout(cfg)
    out: Dict[str, torch.Tensor] = {}
    _flatten({k: v for k, v in tree.items() if k not in ("layers", "encoder")}, "",
             lambda v: v, out)
    for i in range(cfg.num_layers):
        r, p = divmod(i, period)
        _flatten(tree["layers"][p], f"layers.{i}.", lambda v, r=r: v[r], out)
    if "encoder" in tree:
        enc = tree["encoder"]
        _flatten({k: v for k, v in enc.items() if k != "layers"}, "encoder.", lambda v: v, out)
        for i in range(cfg.encoder_layers):
            _flatten(enc["layers"][0], f"encoder.layers.{i}.", lambda v, i=i: v[i], out)
    return out


def _leaf_path(model: nn.Module, key: str):
    """A ``CausalLM`` state-dict key without its layer prefix (``attn.wq.weight``,
    under the module path ``module``) → (the reference's path below the
    layer, transposed?): a linear's weight is ``w`` (d_in, d_out), a Mamba2
    projection's the leaf ``in_proj``/``out_proj``, an embedding's
    ``table``, a linear's bias ``b``; the rest keep their names."""
    *mods, leaf = key.split(".")
    owner = model.get_submodule(".".join(mods)) if mods else model
    if isinstance(owner, Linear) and leaf == "weight":
        if mods and mods[-1] in ("in_proj", "out_proj"):
            return tuple(mods), True
        return (*mods, "w"), True
    if isinstance(owner, Linear) and leaf == "bias":
        return (*mods, "b"), False
    if isinstance(owner, Embedding):
        return (*mods, "table"), False
    return (*mods, leaf), False


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU copy in the tensor's dtype; bf16 as ``ml_dtypes``' bfloat16
    when numpy knows it (JAX installs it), else as float32."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        from ml_dtypes import bfloat16
    except ImportError:
        return t.float().numpy()
    return t.contiguous().view(torch.int16).numpy().view(bfloat16)


@dataclass(frozen=True)
class LeafSpec:
    """A leaf's shape and dtype (what ``checkpoint.load_checkpoint`` reads
    from its ``like``)."""
    shape: tuple
    dtype: torch.dtype


#: leaf and stack functions of ``lm_tree``'s three forms
_FORMS = {
    "numpy": (lambda t: np.ascontiguousarray(_to_numpy(t)), np.stack),
    "tensor": (lambda t: t.detach().cpu().contiguous(), torch.stack),
    "spec": (lambda t: LeafSpec(tuple(t.shape), t.dtype),
             lambda xs: LeafSpec((len(xs),) + xs[0].shape, xs[0].dtype)),
}


def reference_leaves(cfg, model: "CausalLM"):
    """Each of ``model``'s state-dict entries with where the JAX package's
    ``init_params`` tree keeps it: yields (key, tensor, the tree path —
    ``("layers", "[p]", ...)`` for a layer of period position p —, whether
    the leaf is a layer stack ``(repeats, …)`` there, and whether the
    reference's matrix is this tensor's transpose)."""
    _, period, _ = layout(cfg)
    for key, p in model.state_dict().items():
        parts = key.split(".")
        head = 1 if parts[0] == "layers" else 2 if parts[:2] == ["encoder", "layers"] else 0
        if not head:
            path, tr = _leaf_path(model, key)
            yield key, p, path, False, tr
            continue
        i = int(parts[head])
        sub = model.get_submodule(".".join(parts[:head + 1]))
        path, tr = _leaf_path(sub, ".".join(parts[head + 1:]))
        pos = i % period if head == 1 else 0
        yield key, p, (*parts[:head], f"[{pos}]", *path), True, tr


def lm_tree(cfg, model: "CausalLM", form: str = "numpy") -> dict:
    """``model``'s parameters as the JAX package's ``init_params`` tree: each
    layer stack ``(repeats, …)`` per period position, ``(d_in, d_out)``
    matrices, ``table``/``w``/``b`` names. Leaves are numpy arrays in the
    parameters' dtype (``form="numpy"``), CPU tensors (``"tensor"``) or
    ``LeafSpec``s (``"spec"``)."""
    leaf, stack = _FORMS[form]
    tree: dict = {}
    stacks: Dict[tuple, list] = {}
    for _, p, path, stacked, tr in reference_leaves(cfg, model):
        value = leaf(p.T if tr else p)
        if stacked:
            stacks.setdefault(path, []).append(value)
        else:
            _set(tree, path, value)
    for path, leaves in stacks.items():
        j = next(i for i, k in enumerate(path) if k.startswith("["))
        root, pos = path[:j], int(path[j][1:-1])
        node = tree
        for k in root[:-1]:
            node = node.setdefault(k, {})
        positions = node.setdefault(root[-1], [])
        while len(positions) <= pos:
            positions.append({})
        _set(positions[pos], path[j + 1:], stack(leaves))
    return tree


def lm_params_to_numpy(cfg, model: "CausalLM") -> dict:
    """The inverse of ``lm_params_from_numpy``: ``model``'s parameters as the
    JAX package's tree with numpy leaves in the parameters' dtype, which the
    reference's ``forward`` and ``save_checkpoint`` take as they are."""
    return lm_tree(cfg, model, "numpy")
