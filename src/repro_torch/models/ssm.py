"""Mamba2 block — the SSD (state-space duality) chunked scan: the port of the
JAX package's ``models/ssm.py``.

Per arXiv:2405.21060. The sequence is split into chunks of ``Q`` tokens;
within a chunk the recurrence is a masked, decayed attention-like quadratic
form, across chunks a small (H, P, N) state is carried. Decode is a single
O(1) state update.

``Mamba2Mixer.forward`` (``ssm_block``) and ``prefill`` (``ssm_prefill``)
run the SSD through the chunk kernel (``kernels/ssd_scan``); the JAX package
calls its jnp ``ssd`` there and never its own Pallas kernel, which computes
the same function. The plain ``ssd``/``ssd_chunk`` below are the
counterparts of the JAX package's, kept for the tests. Caches are dicts
``{"state", "conv"}`` that prefill and decode update in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import Linear, normal_
from repro_torch.sharding import cores
from repro_torch.sharding.context import batch_rows


def _segsum_matrix(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays → L (..., Q, Q) with L[s,t] = exp(Σ_{t<τ≤s} a_τ)
    for t ≤ s, else 0."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    causal = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    return torch.where(causal, torch.exp(diff), 0.0)


def ssd_chunk(x, dt, A, Bm, Cm, state) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the SSD scan, plain: x (B, Q, H, P), dt (B, Q, H), A (H,),
    B/C (B, Q, G, N), state (B, H, P, N) → (y (B, Q, H, P), new state)."""
    b, q, h, p = x.shape
    rep = h // Bm.shape[2]
    a_t = (dt * A[None, None, :]).transpose(1, 2)                        # (B,H,Q)
    cum = torch.cumsum(a_t, dim=-1)
    scores = torch.einsum("bsgn,btgn->bgst", Cm.float(), Bm.float())
    scores = scores.repeat_interleave(rep, dim=1)                        # (B,H,Q,Q)
    w = scores * _segsum_matrix(a_t) * dt.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhst,bthp->bshp", w.to(x.dtype), x)
    decay_out = torch.exp(cum).transpose(1, 2)                           # (B,Q,H)
    c_rep = Cm.repeat_interleave(rep, dim=2)
    y_inter = torch.einsum("bqhn,bhpn->bqhp", c_rep.float(), state.float())
    y = y + (y_inter * decay_out[..., None]).to(x.dtype)
    decay_to_end = torch.exp(cum[..., -1:] - cum).transpose(1, 2)        # (B,Q,H)
    b_rep = Bm.repeat_interleave(rep, dim=2)
    dx = x.float() * (dt * decay_to_end)[..., None]
    chunk_state = torch.einsum("bqhp,bqhn->bhpn", dx, b_rep.float())
    new_state = state * torch.exp(cum[..., -1])[..., None, None] + chunk_state
    return y, new_state


def ssd(x, dt, A, Bm, Cm, chunk: int, state: Optional[torch.Tensor] = None):
    """Chunked SSD over a whole sequence, plain (a loop over chunks):
    x (B, S, H, P) → (y, final state (B, H, P, N))."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    if state is None:
        state = torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, q):
        y, state = ssd_chunk(x[:, c0:c0 + q], dt[:, c0:c0 + q], A, Bm[:, c0:c0 + q],
                             Cm[:, c0:c0 + q], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + silu. x: (B, S, C), w: (W, C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i:i + x.shape[1], :].float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def _split_proj(cfg, proj: torch.Tensor):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    g, n = s.n_groups, s.d_state
    h = s.num_heads(cfg.d_model)
    z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, h], dim=-1)
    return z, xbc, dt, di, g, n, h


def init_ssm_cache(cfg, batch: int, dtype, device=None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.num_heads(d)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return {
        "state": torch.zeros(batch, h, s.head_dim, s.d_state, dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(batch, s.conv_width - 1, conv_ch, dtype=dtype, device=device),
    }


class Mamba2Mixer(nn.Module):
    """The Mamba2 mixer: in_proj → causal conv → SSD → gated RMSNorm →
    out_proj. ``A_log``, ``D`` and ``dt_bias`` are fp32, the rest in the
    model's dtype, as the JAX package's ``init_ssm`` stores them."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        di = s.d_inner(d)
        h = s.num_heads(d)
        g, n, w = s.n_groups, s.d_state, s.conv_width
        conv_ch = di + 2 * g * n
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = Linear(d, 2 * di + 2 * g * n + h, device=device, dtype=dtype)
        self.conv_w = nn.Parameter(torch.empty(w, conv_ch, device=device, dtype=dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, device=device, dtype=dtype))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, h + 1, **f32)))
        self.D = nn.Parameter(torch.ones(h, **f32))
        self.dt_bias = nn.Parameter(torch.empty(h, **f32))
        self.norm_scale = nn.Parameter(torch.ones(di, device=device, dtype=dtype))
        self.out_proj = Linear(di, d, device=device, dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's ``init_ssm`` laws: in/out projections N(0, 1) /
        sqrt(d_in), conv N(0, 1)·0.1, ``dt_bias = softplus⁻¹(dt_init)`` with
        ``log dt_init`` uniform on [log dt_min, log dt_max]."""
        s = self.cfg.ssm
        self.in_proj.reset_parameters(generator)
        normal_(self.conv_w, generator, 0.1)
        u = torch.rand(self.dt_bias.shape, generator=generator, device=self.dt_bias.device)
        dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
        self.dt_bias.copy_(torch.log(torch.expm1(dt_init)))
        self.out_proj.reset_parameters(generator)

    def _ssd_inputs(self, xbc: torch.Tensor, dtp: torch.Tensor, di: int, g: int, n: int,
                    h: int):
        b, s = xbc.shape[:2]
        xh, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xh = xh.reshape(b, s, h, self.cfg.ssm.head_dim)
        bm = bm.reshape(b, s, g, n)
        cm = cm.reshape(b, s, g, n)
        dt = F.softplus(dtp.float() + self.dt_bias)
        return xh, bm, cm, dt, -torch.exp(self.A_log)

    def _conv(self, xbc: torch.Tensor) -> torch.Tensor:
        """The causal conv and silu; under a mesh on each rank's rows."""
        if isinstance(xbc, DTensor):
            return cores.per_rows(_causal_conv, xbc, self.conv_w, self.conv_b)
        return _causal_conv(xbc, self.conv_w, self.conv_b)

    def _gate_out(self, y: torch.Tensor, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Gated RMSNorm (Mamba2 style) ``norm(y · silu(z))``, then out_proj."""
        yz = y * F.silu(z.float()).to(y.dtype)
        yzf = yz.float()
        ms = yzf.square().mean(-1, keepdim=True)
        yz = (yzf * torch.rsqrt(ms + self.cfg.norm_eps)).to(u.dtype) * self.norm_scale
        return self.out_proj(yz)

    def _ssd(self, xh, dt, A, bm, cm, chunk: int, state=None):
        """The SSD through the chunk kernel, in fp32 → (y in x's dtype, state)."""
        args = (xh.float(), dt, A, bm.float(), cm.float())
        if isinstance(xh, DTensor):  # each rank's batch rows, every head
            y, final = cores.ssd(ssd_ops.ssd_chunk_kernel_apply, *args, chunk, state)
        else:
            y, final = ssd_ops.ssd_chunk_kernel_apply(*args, chunk=chunk, state=state)
        return y.to(xh.dtype), final

    def forward(self, u: torch.Tensor, state: Optional[torch.Tensor] = None):
        """Full block over a sequence (``ssm_block``). u: (B, S, d) →
        (y, final SSD state). S must be a multiple of ``min(chunk, S)``."""
        b, s, _ = u.shape
        z, xbc, dtp, di, g, n, h = _split_proj(self.cfg, batch_rows(self.in_proj(u)))
        xbc = self._conv(xbc)
        xh, bm, cm, dt, A = self._ssd_inputs(xbc, dtp, di, g, n, h)
        y, final_state = self._ssd(xh, dt, A, bm, cm, self.cfg.ssm.chunk_size, state)
        y = y + xh * self.D[None, None, :, None]
        return self._gate_out(y.reshape(b, s, di), z, u), final_state

    def prefill(self, u: torch.Tensor, cache: dict) -> torch.Tensor:
        """Full-sequence pass that also fills the decode cache (the SSD state
        and the last W−1 pre-conv rows). The sequence is padded to a chunk
        multiple with dt = 0 rows, which leave the state unchanged."""
        cfg = self.cfg
        b, s, _ = u.shape
        z, xbc_raw, dtp, di, g, n, h = _split_proj(cfg, batch_rows(self.in_proj(u)))
        w = cfg.ssm.conv_width
        if s >= w - 1:
            tail = xbc_raw[:, s - (w - 1):, :]
        else:
            tail = F.pad(xbc_raw, (0, 0, w - 1 - s, 0))
        xbc = self._conv(xbc_raw)
        xh, bm, cm, dt, A = self._ssd_inputs(xbc, dtp, di, g, n, h)
        q = min(cfg.ssm.chunk_size, s)
        pad = (q - s % q) % q
        xs, bs, cs, dts = xh, bm, cm, dt
        if pad:
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            bs = F.pad(bm, (0, 0, 0, 0, 0, pad))
            cs = F.pad(cm, (0, 0, 0, 0, 0, pad))
            dts = F.pad(dt, (0, 0, 0, pad))
        y, final_state = self._ssd(xs, dts, A, bs, cs, q)
        y = y[:, :s] + xh * self.D[None, None, :, None]
        cache["state"].copy_(final_state)
        cache["conv"].copy_(tail.to(cache["conv"].dtype))
        return self._gate_out(y.reshape(b, s, di), z, u)

    def decode(self, u: torch.Tensor, cache: dict) -> torch.Tensor:
        """Single-token decode (``ssm_decode_step``). u: (B, 1, d)."""
        cfg = self.cfg
        b = u.shape[0]
        z, xbc, dtp, di, g, n, h = _split_proj(cfg, batch_rows(self.in_proj(u[:, 0])))
        hist = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)          # (B, W, C)
        conv_out = (hist.float() * self.conv_w.float()).sum(1)
        xbc_t = F.silu(conv_out + self.conv_b.float()).to(u.dtype)
        cache["conv"].copy_(hist[:, 1:])
        xh, bm, cm = torch.split(xbc_t, [di, g * n, g * n], dim=-1)
        xh = xh.reshape(b, h, cfg.ssm.head_dim)
        rep = h // g
        bmr = bm.reshape(b, g, n).repeat_interleave(rep, dim=1)            # (B, H, N)
        cmr = cm.reshape(b, g, n).repeat_interleave(rep, dim=1)
        dt = F.softplus(dtp.float() + self.dt_bias)                         # (B, H)
        decay = torch.exp(dt * -torch.exp(self.A_log)[None, :])
        upd = (dt[..., None] * xh.float())[..., None] * bmr[:, :, None, :].float()
        state = cache["state"] * decay[..., None, None] + upd               # (B, H, P, N)
        cache["state"].copy_(state)
        if isinstance(state, DTensor):  # no product over a (B·H) dim split on two mesh axes
            y = (state * cmr.float()[:, :, None, :]).sum(-1)
        else:
            y = torch.einsum("bhpn,bhn->bhp", state, cmr.float())
        y = y + xh.float() * self.D[None, :, None]
        yz = y.reshape(b, di) * F.silu(z.float())
        ms = yz.square().mean(-1, keepdim=True)
        yz = yz * torch.rsqrt(ms + cfg.norm_eps)
        yz = (yz * self.norm_scale.float()).to(u.dtype)
        return self.out_proj(yz)[:, None, :]
