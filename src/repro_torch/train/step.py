"""Step functions: train (with gradient accumulation), prefill, decode — the
port of the JAX package's ``train/step.py``.

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) →
(state, metrics)``, one optimizer step over the global batch: the batch is
cut into ``tcfg.microbatches`` strided microbatches (microbatch ``j`` takes
rows ``j, j + n, j + 2n, …``, the reference's ``reshape(B/n, n,
…).swapaxes(0, 1)``), each one's gradients are summed into float32 zeros
and divided by n, the loss is their mean and the other metrics the last
microbatch's; then AdamW at ``cosine_schedule(step + 1)``. The model and the
optimizer's moments are updated in place (``optim/adamw.py``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import CausalLM, init_params, lm_params_from_numpy
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, moment_dtype_of
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.train.loss import lm_loss

Tensors = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    model: CausalLM
    opt: AdamWState


def init_train_state(generator: Optional[torch.Generator], cfg, *, moment_dtype="float32",
                     device=None) -> TrainState:
    """A model drawn from ``generator`` (``models.init_params``) and zero
    AdamW moments of ``moment_dtype`` beside it."""
    model = init_params(cfg, generator, device=device)
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        moment_dtype=moment_dtype))


def train_state_from_numpy(cfg, params: dict, opt=None, *, device=None) -> TrainState:
    """The JAX package's ``TrainState`` pieces — its ``params`` tree and its
    ``AdamWState`` (``step``, ``mu``, ``nu``), numpy leaves — as this
    port's: the moments go over ``lm_params_from_numpy``'s map and keep
    their dtype (bf16 moments stay bf16); without ``opt``, zero moments."""
    model = CausalLM(cfg, device=device)
    model.load_state_dict(lm_params_from_numpy(cfg, params))
    named = dict(model.named_parameters())
    if opt is None:
        return TrainState(model, adamw_init(named))
    stored = np.asarray(opt.mu["embed"]["table"]).dtype.name
    mdt = moment_dtype_of("bfloat16" if stored == "bfloat16" else "float32")
    mu, nu = (lm_params_from_numpy(cfg, tree) for tree in (opt.mu, opt.nu))
    return TrainState(model, AdamWState(
        step=torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32),
        mu={k: mu[k].to(device=p.device, dtype=mdt) for k, p in named.items()},
        nu={k: nu[k].to(device=p.device, dtype=mdt) for k, p in named.items()}))


def make_grad_fn(cfg, tcfg):
    """``grad_fn(model, batch) → (loss, metrics, grads)``: the train step's
    forward and backward passes over the microbatches, before the update.
    ``grads`` is keyed by parameter name: float32 sums over n microbatches
    divided by n, or, with one microbatch, the gradients in the parameters'
    dtype, as the reference's."""

    def loss_fn(model, mb):
        return lm_loss(model, cfg, mb["tokens"], mb["labels"], frames=mb.get("frames"),
                       patches=mb.get("patches"), ce_chunk=tcfg.ce_chunk, z_loss=tcfg.z_loss)

    def grad_fn(model: CausalLM, batch: Dict[str, torch.Tensor]):
        names, params = zip(*model.named_parameters())
        n = tcfg.microbatches
        if n <= 1:
            loss, metrics = loss_fn(model, batch)
            grads = _grad(loss, params)
            return loss.detach(), _detach(metrics), dict(zip(names, grads))
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"global batch {b} is not a multiple of {n} microbatches")
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        lsum = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for j in range(n):
            mb = {k: microbatch(v, j, n) for k, v in batch.items() if v is not None}
            loss, metrics = loss_fn(model, mb)
            for acc, g in zip(gsum, _grad(loss, params)):
                acc.add_(g)
            lsum = lsum + loss.detach()
        return lsum / n, _detach(metrics), {k: g / n for k, g in zip(names, gsum)}

    return grad_fn


def microbatch(v: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """Rows ``j, j + n, j + 2n, …`` of ``v``. A DTensor whose batch rows
    are split in blocks that n divides takes them from each rank's own
    block, with no exchange (the global rows j::n are each block's local
    rows j::n)."""
    if not isinstance(v, DTensor):
        return v[j::n]
    local = v.to_local()
    if local.shape[0] % n:
        return v[j::n]
    shape = (v.shape[0] // n, *v.shape[1:])
    return DTensor.from_local(local[j::n].contiguous(), v.device_mesh, v.placements,
                              run_check=False,
                              shape=shape, stride=torch.empty(shape, device="meta").stride())


def _grad(loss, params):
    """d loss / d params; a parameter the loss does not reach (a VLM's
    ``patch_proj`` without patches) gets zeros, as under ``jax.grad``."""
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def _detach(metrics: Dict) -> Dict:
    return {k: v.detach() for k, v in metrics.items()}


def apply_update(state: TrainState, grads: Tensors, tcfg) -> Tuple[TrainState, torch.Tensor]:
    """AdamW at ``cosine_schedule(opt.step + 1)`` → (the new state, lr)."""
    lr = cosine_schedule(state.opt.step + 1, base_lr=tcfg.learning_rate,
                         warmup=tcfg.warmup_steps, total=tcfg.total_steps)
    opt = adamw_update(grads, state.opt, dict(state.model.named_parameters()), lr=lr,
                       b1=tcfg.b1, b2=tcfg.b2, weight_decay=tcfg.weight_decay,
                       grad_clip=tcfg.grad_clip)
    return TrainState(state.model, opt), lr


def make_train_step(cfg, tcfg):
    """Returns ``train_step(state, batch) → (state, metrics)``; ``batch`` is
    ``{tokens, labels[, frames, patches]}`` on the model's device, metrics
    ``nll``, ``aux``, ``z``, ``loss`` (0-d tensors on the device) and
    ``lr`` (a 0-d CPU tensor)."""
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics, grads = grad_fn(state.model, batch)
        state, lr = apply_update(state, grads, tcfg)
        return state, dict(metrics, loss=loss, lr=lr)

    return train_step


def make_prefill_step(cfg):
    def prefill_step(model, tokens, cache, frames=None, patches=None):
        return model.prefill(tokens, cache, frames=frames, patches=patches), cache

    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, token, cache, cache_pos):
        return model.decode_step(token, cache, cache_pos), cache

    return decode_step
