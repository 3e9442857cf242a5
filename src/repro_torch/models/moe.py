"""Top-k mixture-of-experts with capacity-based gather dispatch — the port of
the JAX package's ``models/moe.py`` (``init_moe``, ``capacity``,
``apply_moe_gather``).

Routing is fp32 whatever the model's dtype. Each token picks its top-k
experts by router probability, ties going to the lower expert id as
``jax.lax.top_k`` does (a stable descending sort: ``torch.topk`` promises no
order among equal values). An assignment's position inside its expert is an
exclusive cumulative sum over the token-major (T·k, E) one-hot; assignments
at or past the capacity go to the drop row ``E·C`` and are lost, the
residual path keeping those tokens intact. The kept tokens are gathered into
an (E, C, d) buffer, the experts run as batched products (plain library
products: the reference's ``einsum``s run outside any Pallas kernel), and the
gated outputs are summed back per token.

``groups="row"`` routes each row of the (B, S, d) input as its own group,
with its own capacity and drops — what the JAX serving engine gets by
decoding every slot alone under ``vmap`` — so a request's tokens never depend
on its neighbours; ``groups="joint"`` (the default) routes all B·S tokens
together, as the JAX ``apply_moe`` does in ``forward``, ``prefill`` and
``decode_step``. Routing stays on the device: no host synchronisation.

The reference's ``impl="alltoall"`` (jamba, kimi) is the shard_map expert-
parallel form, which it takes only under a device mesh; without one it falls
back to this gather path. The port has no mesh, so every card runs the gather
path here; the all-to-all form waits for the port's sharding. K2's
node-limited routing (``route_groups``) exists only inside the all-to-all
form, so the gather path, the reference's and this one, ignores it.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import normal_


def capacity(num_tokens: int, cfg) -> int:
    """Slots per expert for ``num_tokens`` routed together: ``k·t/E`` times
    the capacity factor, rounded up to a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = math.ceil(m.experts_per_token * num_tokens / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) router probabilities → (gate, expert ids), each (T, k): the k
    largest in descending order, equal values in ascending expert order, the
    gates renormalised to sum to 1."""
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k].contiguous()
    return gate / gate.sum(-1, keepdim=True), idx


def dispatch_positions(flat_idx: torch.Tensor, e: int, cap: int):
    """(G, N) expert ids, token-major within each group → (keep mask,
    destination row in a (G·E·C + 1) buffer whose last row is the drop
    row): an assignment is kept when fewer than ``cap`` earlier ones in its
    group chose its expert."""
    g = flat_idx.shape[0]
    onehot = F.one_hot(flat_idx, e).to(torch.int32)                   # (G, N, E)
    pos = torch.cumsum(onehot, dim=1) - onehot                         # exclusive
    pos = pos.gather(2, flat_idx[..., None])[..., 0]                  # (G, N)
    keep = pos < cap
    base = torch.arange(g, device=flat_idx.device)[:, None] * (e * cap)
    dest = torch.where(keep, base + flat_idx * cap + pos, g * e * cap)
    return keep, dest


class MoE(nn.Module):
    """Router (d, E) in fp32; SwiGLU experts ``w_gate``, ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model's dtype, stored as the JAX package
    stores them (not transposed); shared experts, always on, when the card
    has ``num_shared_experts``."""

    def __init__(self, cfg, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, e, device=device, dtype=torch.float32))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))
        self.shared_gate = self.shared_up = self.shared_down = None
        if m.num_shared_experts:
            se = m.num_shared_experts
            self.shared_gate = nn.Parameter(torch.empty(se, d, f, **kw))
            self.shared_up = nn.Parameter(torch.empty(se, d, f, **kw))
            self.shared_down = nn.Parameter(torch.empty(se, f, d, **kw))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_moe``'s laws: router and input-side experts N(0, 1)/sqrt(d),
        output-side N(0, 1)/sqrt(f)."""
        d, f = self.cfg.d_model, self.cfg.moe.d_ff
        for w in (self.router, self.w_gate, self.w_up):
            normal_(w, generator, 1.0 / math.sqrt(d))
        normal_(self.w_down, generator, 1.0 / math.sqrt(f))
        if self.shared_gate is not None:
            normal_(self.shared_gate, generator, 1.0 / math.sqrt(d))
            normal_(self.shared_up, generator, 1.0 / math.sqrt(d))
            normal_(self.shared_down, generator, 1.0 / math.sqrt(f))

    def _route(self, xf: torch.Tensor, g: int):
        """Routing of the (T, d) tokens in ``g`` groups of ``T / g`` → (gate
        (T, k), expert ids (T, k), keep and destination (T·k,), capacity,
        aux)."""
        m = self.cfg.moe
        t = xf.shape[0] // g                 # tokens routed together
        k, e = m.experts_per_token, m.num_experts
        cap = capacity(t, self.cfg)
        probs = torch.softmax(xf.float() @ self.router, dim=-1)          # (T, E)
        gate, idx = route(probs, k)                                      # (T, k)
        # load-balance auxiliary loss (Switch-style), per group
        me = probs.view(g, t, e).mean(1)                                 # (G, E)
        ce = F.one_hot(idx, e).float().sum(1).view(g, t, e).mean(1)
        aux = (e * (me * ce).sum(-1) * m.aux_loss_weight).mean()
        keep, dest = dispatch_positions(idx.view(g, t * k), e, cap)
        return gate, idx, keep.reshape(-1), dest.reshape(-1), cap, aux

    def _dispatch(self, xf: torch.Tensor, dest: torch.Tensor, g: int, cap: int) -> torch.Tensor:
        """Gather the kept assignments' tokens into each expert's slots →
        (E, G·C, d); the drop row is written and cut off."""
        e, d = self.cfg.moe.num_experts, xf.shape[1]
        rows = g * e * cap
        buf = torch.zeros(rows + 1, d, dtype=xf.dtype, device=xf.device)
        buf[dest] = xf.repeat_interleave(self.cfg.moe.experts_per_token, dim=0)  # i // k
        return buf[:rows].view(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    def _experts(self, hidden: torch.Tensor) -> torch.Tensor:
        """The SwiGLU experts on their slots: (E, N, d) → (E, N, d)."""
        h = F.silu(torch.bmm(hidden, self.w_gate)) * torch.bmm(hidden, self.w_up)
        return torch.bmm(h, self.w_down)

    def _combine(self, out: torch.Tensor, dest: torch.Tensor, gate: torch.Tensor,
                 keep: torch.Tensor, g: int, cap: int) -> torch.Tensor:
        """Each token's kept outputs weighted by their gates and summed →
        (T, d): the reference's scatter-add over ``tok_of``, whose k rows
        per token are consecutive."""
        e, _, d = out.shape
        rows = g * e * cap
        out = out.view(e, g, cap, d).transpose(0, 1).reshape(rows, d)
        y_routed = out[dest.clamp(max=rows - 1)]
        w = (gate.reshape(-1) * keep).to(out.dtype)
        return (y_routed * w[:, None]).view(gate.shape[0], gate.shape[1], d).sum(1)

    def _shared(self, xf: torch.Tensor) -> torch.Tensor:
        hs = F.silu(torch.einsum("td,edf->tef", xf, self.shared_gate)) * \
            torch.einsum("td,edf->tef", xf, self.shared_up)
        return torch.einsum("tef,efd->td", hs, self.shared_down)

    def forward(self, x: torch.Tensor, *, groups: str = "joint", details: bool = False):
        """x (B, S, d) → (y (B, S, d), aux) — with ``details``, also a dict of
        the routing: expert ids (B·S, k), keep mask (B·S·k,) and capacity.
        ``aux`` is the Switch load-balance loss of ``apply_moe_gather``; with
        ``groups="row"``, the mean of the rows' losses."""
        b, s, d = x.shape
        if groups not in ("joint", "row"):
            raise ValueError(f"groups must be 'joint' or 'row', got {groups!r}")
        g = b if groups == "row" else 1
        xf = x.reshape(b * s, d)
        gate, idx, keep, dest, cap, aux = self._route(xf, g)
        out = self._experts(self._dispatch(xf, dest, g, cap))
        y = self._combine(out, dest, gate, keep, g, cap)
        if self.shared_gate is not None:
            y = y + self._shared(xf)
        y = y.reshape(b, s, d)
        if details:
            return y, aux, {"idx": idx, "keep": keep, "capacity": cap}
        return y, aux
