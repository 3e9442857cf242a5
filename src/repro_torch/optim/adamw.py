"""AdamW with fp32 (or bf16) moments over the model's (possibly bf16)
parameters — the port of the JAX package's ``optim/adamw.py``.

Written out, not ``torch.optim.AdamW``: the reference differs from it in
three ways that change the numbers, and this port follows the reference.
Weight decay applies to every parameter (norms and embeddings too), added
to the Adam direction before the step, ``p − lr·(m̂/(√v̂ + eps) + wd·p)``;
the clip always scales by ``min(1, clip / (‖g‖ + 1e-9))``; the bias
corrections ``1 − b^step`` are float32. The math is float32 whatever the
moments' dtype, and each parameter is cast back to its own dtype.

Parameters, gradients and moments are dicts keyed by the model's parameter
names (``dict(model.named_parameters())``). ``adamw_update`` writes the new
parameters and moments in place — what the reference returns as new arrays
— so a step holds no second copy of the model. ``step`` stays a 0-d int32
tensor on the CPU: the schedule and the bias corrections are host numbers,
and reading them never waits for the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the CPU
    mu: Tensors
    nu: Tensors


def moment_dtype_of(moment_dtype) -> torch.dtype:
    """``torch.float32`` / ``torch.bfloat16`` from a dtype or its name."""
    if isinstance(moment_dtype, torch.dtype):
        return moment_dtype
    try:
        return _DTYPES[moment_dtype]
    except KeyError:
        raise ValueError(f"unknown moment dtype {moment_dtype!r} "
                         f"({'|'.join(_DTYPES)})") from None


def adamw_init(params: Tensors, *, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter. ``moment_dtype="bfloat16"`` halves
    the optimizer's memory; fp32 is the default for exactness."""
    mdt = moment_dtype_of(moment_dtype)
    zeros = {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=zeros, nu={k: torch.zeros_like(z) for k, z in zeros.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over leaves (added in order) of each leaf's float32
    sum of squares → a 0-d float32 tensor on the leaves' device."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tensors)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 0.0) -> AdamWState:
    """One AdamW step: ``params`` and the moments are updated in place; the
    new state (step + 1, the same moment dicts) is returned. ``lr`` is a
    float or a 0-d CPU tensor (the schedule's)."""
    step = state.step + 1
    stepf = step.float()
    c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
    c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
    lr = float(torch.as_tensor(lr, dtype=torch.float32))
    scale = None
    if grad_clip:
        gn = global_norm(grads[k] for k in params)
        scale = torch.clamp(grad_clip / (gn + 1e-9), max=1.0)
    for k, p in params.items():
        g = grads[k].float()
        if scale is not None:
            g = g * scale
        m, v = state.mu[k], state.nu[k]
        mf = b1 * m.float() + (1 - b1) * g
        vf = b2 * v.float() + (1 - b2) * torch.square(g)
        delta = (mf / c1) / (torch.sqrt(vf / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)
