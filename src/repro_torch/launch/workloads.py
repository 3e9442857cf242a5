"""Workload construction for the dry-run — the port of the JAX package's
``launch/workloads.py``.

``make_workload(cfg, shape, mesh)`` returns the step function, its
arguments and their specs for every (architecture × input shape) pair.
The arguments are DTensors on the mesh, each rank holding its shard; made
under ``FakeTensorMode`` (as the dry-run makes them) they allocate
nothing. ``input_specs`` gives the model inputs' shapes and dtypes alone.

Shape semantics:
  train_4k    → one optimizer step (grad-accumulated microbatches)
  prefill_32k → full-sequence prefill populating a KV cache
  decode_32k  → ONE new token against a seq_len KV cache
  long_500k   → ONE new token against a 524288-token context; requires
                sub-quadratic attention → SSM / hybrid / SWA archs only.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import INPUT_SHAPE_BY_NAME, InputShape, ModelConfig, TrainConfig
from repro_torch.models.blocks import init_layer_cache
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import CausalLM, LeafSpec
from repro_torch.optim.adamw import AdamWState, moment_dtype_of
from repro_torch.sharding import context as shard_ctx
from repro_torch.sharding.specs import (
    batch_spec, cache_specs, local_shard, param_placements, placements)
from repro_torch.train.step import (
    TrainState, apply_update, make_decode_step, make_grad_fn, make_prefill_step)

# long_500k is only valid for sub-quadratic attention (DESIGN.md §4):
LONG_CONTEXT_ARCHS = {"mamba2-2.7b", "jamba-1.5-large-398b", "mixtral-8x22b"}


def supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS:
        return False, "full quadratic attention at 524k context (see DESIGN.md §4)"
    return True, ""


def default_train_config(
    cfg: ModelConfig, shape: InputShape, *, multi_pod: bool = False
) -> TrainConfig:
    # multi-pod: 8 microbatches so each microbatch's 32 sequences still
    # divide the 32-way ('pod','data') batch split (which the MoE's
    # all-to-all form needs).
    return TrainConfig(
        global_batch=shape.global_batch,
        seq_len=shape.seq_len,
        microbatches=8 if multi_pod else 16,
        ce_chunk=1024,  # sequence positions per CE chunk (see train/loss.py)
    )


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, LeafSpec]:
    """The shape and dtype of every model input (no mesh)."""
    shape = INPUT_SHAPE_BY_NAME[shape_name]
    dt = dtype_of(cfg)
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, LeafSpec] = {}
    if shape.kind == "train":
        out["tokens"] = LeafSpec((b, s), torch.int32)
        out["labels"] = LeafSpec((b, s), torch.int32)
    elif shape.kind == "prefill":
        out["tokens"] = LeafSpec((b, s), torch.int32)
    else:
        out["token"] = LeafSpec((b, 1), torch.int32)
        out["cache_pos"] = LeafSpec((), torch.int32)
    if cfg.encoder_layers:
        out["frames"] = LeafSpec((b, cfg.encoder_seq, cfg.d_model), dt)
    if cfg.num_patches and shape.kind != "decode":
        out["patches"] = LeafSpec((b, cfg.num_patches, cfg.d_model), dt)
    return out


def sharded_empty(shape, dtype, mesh: DeviceMesh, pl) -> DTensor:
    """A zero DTensor of global ``shape`` under placements ``pl``: this
    rank's block only (a fake one under ``FakeTensorMode``)."""
    meta = torch.empty(shape, device="meta")
    local = local_shard(meta, pl, mesh.shape, mesh.get_coordinate()).shape
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=mesh.device_type), mesh,
                              pl, run_check=False, shape=meta.shape, stride=meta.stride())


def sharded_model(cfg: ModelConfig, mesh: DeviceMesh, *, layout: str = "tp",
                  requires_grad: bool = False) -> CausalLM:
    """A ``CausalLM`` whose parameters are DTensors placed by the spec
    rules (``sharding.specs.param_placements``), zero-filled."""
    model = CausalLM(cfg, device="meta")
    pl = param_placements(cfg, model, mesh, layout=layout)
    for key, p in list(model.named_parameters()):
        owner, _, leaf = key.rpartition(".")
        param = nn.Parameter(sharded_empty(p.shape, p.dtype, mesh, pl[key]),
                             requires_grad=requires_grad)
        setattr(model.get_submodule(owner) if owner else model, leaf, param)
    return model


def sharded_cache(cfg, model: CausalLM, mesh: DeviceMesh, batch: int, cache_len: int, *,
                   multi_pod: bool):
    """The model's cache as DTensors placed by ``cache_specs``."""
    plain = [init_layer_cache(cfg, layer.kind, batch, cache_len, dtype_of(cfg), "meta")
             for layer in model.layers]
    specs = cache_specs(plain, cfg, batch, multi_pod=multi_pod)["layers"]
    return [{part: {k: sharded_empty(t.shape, t.dtype, mesh,
                                     placements(specs[i][part][k], mesh, stacked=True))
                    for k, t in tensors.items()}
             for part, tensors in layer.items()}
            for i, layer in enumerate(plain)], specs


def _batch_tensor(shape, dtype, mesh, spec) -> DTensor:
    lead = spec[0]
    return sharded_empty(shape, dtype, mesh, placements((lead,) + (None,) * (len(shape) - 1),
                                                         mesh))


def _train_step(cfg, tcfg):
    """``train.step.make_train_step``'s step, its update run with the fake
    mode set aside: the schedule and AdamW's bias corrections are host
    numbers of the real step count, the parameters and moments stay fake
    DTensors (a fake tensor keeps its mode)."""
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(state, batch):
        loss, metrics, grads = grad_fn(state.model, batch)
        with unset_fake_temporarily():
            state, lr = apply_update(state, grads, tcfg)
        return state, dict(metrics, loss=loss, lr=lr)

    return train_step


def make_workload(
    cfg: ModelConfig,
    shape_name: str,
    mesh: DeviceMesh,
    *,
    multi_pod: bool = False,
    tcfg: Optional[TrainConfig] = None,
    layout: str = "tp",
) -> Dict[str, Any]:
    """→ {fn, args (DTensors), in_specs, out_specs, kind}.

    layout: "tp" (tensor/expert parallel — default production rules) or
    "dp" (fully data-parallel, small-card training). Sets the ambient mesh,
    which the MoE's all-to-all form reads."""
    shape = INPUT_SHAPE_BY_NAME[shape_name]
    ok, why = supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} × {shape_name} unsupported: {why}")
    shard_ctx.set_mesh(mesh)
    bspec = batch_spec(multi_pod, layout=layout)
    dt = dtype_of(cfg)

    def extras(b, kind):
        out = {}
        if cfg.encoder_layers:
            out["frames"] = _batch_tensor((b, cfg.encoder_seq, cfg.d_model), dt, mesh, bspec)
        if cfg.num_patches and kind != "decode":
            out["patches"] = _batch_tensor((b, cfg.num_patches, cfg.d_model), dt, mesh, bspec)
        return out

    if shape.kind == "train":
        tcfg = tcfg or default_train_config(cfg, shape, multi_pod=multi_pod)
        model = sharded_model(cfg, mesh, layout=layout, requires_grad=True)
        mdt = moment_dtype_of(tcfg.moment_dtype)
        named = dict(model.named_parameters())
        with unset_fake_temporarily():  # the step count is a host number
            step = torch.zeros((), dtype=torch.int32)
        opt = AdamWState(step=step,
                         mu={k: sharded_empty(p.shape, mdt, mesh, p.placements)
                             for k, p in named.items()},
                         nu={k: sharded_empty(p.shape, mdt, mesh, p.placements)
                             for k, p in named.items()})
        b, s = tcfg.global_batch, tcfg.seq_len
        batch = {"tokens": _batch_tensor((b, s), torch.int32, mesh, bspec),
                 "labels": _batch_tensor((b, s), torch.int32, mesh, bspec), **extras(b, "train")}
        return {"fn": _train_step(cfg, tcfg), "args": (TrainState(model, opt), batch),
                "in_specs": ("state", bspec), "out_specs": ("state", None), "kind": "train"}

    model = sharded_model(cfg, mesh, layout=layout)
    if shape.kind == "prefill":
        b, s = shape.global_batch, shape.seq_len
        # VLM: the cache also holds the visual-prefix positions
        cache, cspec = sharded_cache(cfg, model, mesh, b, s + cfg.num_patches,
                                      multi_pod=multi_pod)
        tokens = _batch_tensor((b, s), torch.int32, mesh, bspec)
        base = make_prefill_step(cfg)
        kw = extras(b, "prefill")
        return {"fn": lambda m, t, c: base(m, t, c, **kw), "args": (model, tokens, cache),
                "in_specs": ("params", bspec, cspec), "out_specs": (None, cspec),
                "kind": "prefill"}

    # decode: ONE token against a cache of shape.seq_len
    b, t = shape.global_batch, shape.seq_len
    cache, cspec = sharded_cache(cfg, model, mesh, b, t, multi_pod=multi_pod)
    tok_spec = bspec if b > 1 else (None, None)
    token = _batch_tensor((b, 1), torch.int32, mesh, tok_spec)
    pos = torch.zeros((), dtype=torch.int32)
    return {"fn": make_decode_step(cfg), "args": (model, token, cache, pos),
            "in_specs": ("params", tok_spec, cspec, ()), "out_specs": (None, cspec),
            "kind": "decode"}
