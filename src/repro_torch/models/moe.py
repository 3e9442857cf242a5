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

**The expert-parallel form** (``apply_moe_alltoall``, the reference's
shard_map ``apply_moe_alltoall``; jamba and kimi ask for it with
``impl="alltoall"``). Each rank holds the experts of its ``data`` index
(``E / data`` of them, their hidden dim split over ``model``) and its slice
of the batch. It routes its own tokens, packs each (token, destination)
into fixed slots of ``cap1`` per data rank, exchanges them with one
``all_to_all`` over the ``data`` group, runs its experts on what it got
(``cap2`` slots per local expert), and sends the results back with a
second ``all_to_all``; the backward pass is the transposed pair. The local
expert id rides in channel d of the payload (``+1``, 0 for an empty slot).
K2's node-limited routing (``route_groups`` G with ``0 < G < data``) lets a
token use only experts on its top-G data ranks and sends one row per
(token, rank), carrying the gates of that rank's experts in channels
``d..d+E_l``. The ``model`` partial sums are reduced once, on the (T, d)
outputs; the load-balance aux is averaged over the batch axes. Slot order
is the exclusive cumulative sum of ``dispatch_positions``, so drops match
the reference's exactly. ``MoE.forward`` takes this form when a mesh is set
(``sharding.context``), the experts divide ``data`` and the batch divides
the batch axes, as the reference's ``apply_moe`` does; else the gather
path (under a mesh, the whole layer on every rank: ``sharding.cores.gather_moe``),
which ignores ``route_groups`` (as the reference's does).

Two settings run the same code: ranks of a real process group (``gloo``
on the CPU or with several ranks on one card; every rank holds plain local
tensors), and the dry-run's DTensors over a fake group of 256 or 512 ranks,
whose local shards reach it through ``local_map``. The collectives are the
functional ones (``torch.distributed._functional_collectives``), so the
dry-run's accounting sees them; a caller's ``traffic``
(``core.parties.Traffic``) records what each rank hands to the backend.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import normal_
from repro_torch.sharding import comm, cores
from repro_torch.sharding import context as shard_ctx
from repro_torch.sharding.specs import placements


def routed_experts(hidden: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                   down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their slots: (E, N, d) → (E, N, d)."""
    return torch.bmm(F.silu(torch.bmm(hidden, gate)) * torch.bmm(hidden, up), down)


def shared_experts(xf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                   down: torch.Tensor) -> torch.Tensor:
    """The always-on SwiGLU experts: (T, d) tokens → (T, d), summed over
    the experts (``gate``/``up`` (S, d, f), ``down`` (S, f, d))."""
    hs = F.silu(torch.einsum("td,edf->tef", xf, gate)) * torch.einsum("td,edf->tef", xf, up)
    return torch.einsum("tef,efd->td", hs, down)


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

    def _route(self, xf: torch.Tensor, g: int, router: torch.Tensor):
        """Routing of the (T, d) tokens in ``g`` groups of ``T / g`` → (gate
        (T, k), expert ids (T, k), keep and destination (T·k,), capacity,
        aux)."""
        m = self.cfg.moe
        t = xf.shape[0] // g                 # tokens routed together
        k, e = m.experts_per_token, m.num_experts
        cap = capacity(t, self.cfg)
        probs = torch.softmax(xf.float() @ router, dim=-1)               # (T, E)
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
        return routed_experts(hidden, self.w_gate, self.w_up, self.w_down)

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
        return shared_experts(xf, self.shared_gate, self.shared_up, self.shared_down)

    def forward(self, x: torch.Tensor, *, groups: str = "joint", details: bool = False):
        """x (B, S, d) → (y (B, S, d), aux) — with ``details``, also a dict of
        the routing: expert ids (B·S, k), keep mask (B·S·k,) and capacity.
        ``aux`` is the Switch load-balance loss of ``apply_moe_gather``; with
        ``groups="row"``, the mean of the rows' losses."""
        b, s, d = x.shape
        if groups not in ("joint", "row"):
            raise ValueError(f"groups must be 'joint' or 'row', got {groups!r}")
        mesh = shard_ctx.get_mesh()
        if uses_alltoall(self.cfg, mesh, x):
            return self._alltoall(x, mesh)
        if isinstance(x, DTensor):
            return self._gather_sharded(x, mesh)
        g = b if groups == "row" else 1
        xf = x.reshape(b * s, d)
        gate, idx, keep, dest, cap, aux = self._route(xf, g, self.router)
        out = self._experts(self._dispatch(xf, dest, g, cap))
        y = self._combine(out, dest, gate, keep, g, cap)
        if self.shared_gate is not None:
            y = y + self._shared(xf)
        y = y.reshape(b, s, d)
        if details:
            return y, aux, {"idx": idx, "keep": keep, "capacity": cap}
        return y, aux

    def node_limited(self, x: torch.Tensor, groups: int, cap: int):
        """The gather path on router probabilities restricted to each token's
        top ``route_groups`` of ``groups`` expert groups, at ``cap`` slots
        per expert → (y (B, S, d), keep mask (B·S·k,)): what the all-to-all
        form's node-limited branch computes over ``groups`` data ranks
        where nothing drops. The card's checks hold that branch against
        it."""
        b, s, d = x.shape
        m = self.cfg.moe
        xf = x.reshape(b * s, d)
        probs = torch.softmax(xf.float() @ self.router, dim=-1)
        gate, idx = route(restrict_to_groups(probs, groups, m.route_groups)[0],
                          m.experts_per_token)
        keep, dest = dispatch_positions(idx.view(1, -1), m.num_experts, cap)
        keep, dest = keep.reshape(-1), dest.reshape(-1)
        y = self._combine(self._experts(self._dispatch(xf, dest, 1, cap)), dest, gate, keep,
                          1, cap)
        if self.shared_gate is not None:
            y = y + self._shared(xf)
        return y.reshape(b, s, d), keep

    def _gather_sharded(self, x: DTensor, mesh):
        """The gather path under a mesh, with the experts left in their
        specs' layout: every rank routes all the tokens (the capacity is
        counted over all of them, as in one process) and runs its shard of
        the experts — the experts over ``data`` and their hidden dim over
        ``model`` (expert parallelism), or, for few-expert cards, d over
        ``data`` and the hidden dim over ``model`` — on the slots of its
        experts. The partial outputs are summed once, into x's layout; the
        shared experts run on each rank's own rows."""
        names = mesh.mesh_dim_names
        w_gate, w_up, w_down = self.w_gate, self.w_up, self.w_down

        def axis_of(w, dim):
            axes = [a for a, p in zip(names, w.placements) if isinstance(p, Shard) and p.dim == dim]
            if len(axes) > 1:
                raise ValueError(f"an expert dim split over {axes}: one axis at most")
            return axes[0] if axes else None

        e_ax, d_ax, f_ax = (axis_of(w_gate, i) for i in range(3))
        if (tuple(w_up.placements) != tuple(w_gate.placements)
                or (axis_of(w_down, 0), axis_of(w_down, 1), axis_of(w_down, 2)) != (e_ax, f_ax, d_ax)):
            raise ValueError("w_up and w_down must be laid out as w_gate is")
        split = tuple(a for a in (e_ax, d_ax, f_ax) if a)   # the axes the expert work is cut over
        shares = math.prod(shard_ctx.axis_size(mesh, a) for a in split)
        whole = (Replicate(),) * mesh.ndim
        part = cores.partial_over(mesh, split)
        d_group = mesh.get_group(d_ax) if d_ax else None
        k = self.cfg.moe.experts_per_token

        def core(router, wg, wu, wd, xl):
            b, s, d = xl.shape
            xf = xl.reshape(b * s, d)
            gate, _, keep, dest, cap, aux = self._route(xf, 1, router)
            e_l, d_l = wg.shape[:2]
            e0 = mesh.get_local_rank(e_ax) * e_l if e_ax else 0
            d0 = mesh.get_local_rank(d_ax) * d_l if d_ax else 0
            rows = e_l * cap
            local = dest - e0 * cap                          # this rank's experts' slots
            mine = (local >= 0) & (local < rows)
            slot = torch.where(mine, local, rows)
            buf = xf.new_zeros(rows + 1, d_l)
            buf[slot] = xf[:, d0:d0 + d_l].repeat_interleave(k, dim=0)
            hidden = buf[:rows].view(e_l, cap, d_l)
            hg, hu = torch.bmm(hidden, wg), torch.bmm(hidden, wu)
            if d_group is not None:  # summed over d's pieces; its cotangent too
                hg = comm.replicated(comm.sum_over(hg, d_group), d_group)
                hu = comm.replicated(comm.sum_over(hu, d_group), d_group)
            out = torch.bmm(F.silu(hg) * hu, wd).reshape(rows, -1)   # partial over f
            w = (gate.reshape(-1) * (keep & mine)).to(out.dtype)
            y = (out[slot.clamp(max=rows - 1)] * w[:, None]).view(b * s, k, -1).sum(1)
            # every rank computed the aux whole: each takes its share of the cotangent
            return y.view(b, s, -1), comm.mean_over(aux, (), shares)

        y_pl = tuple(Shard(2) if a == d_ax else Partial() if a in split else Replicate()
                     for a in names)
        y, aux = local_map(
            core, out_placements=(y_pl, whole),
            in_placements=(whole, w_gate.placements, w_up.placements, w_down.placements, whole),
            in_grad_placements=(part, w_gate.placements, w_up.placements, w_down.placements,
                                part),
            device_mesh=mesh, redistribute_inputs=True)(self.router, w_gate, w_up, w_down, x)
        if self.shared_gate is None:
            return y.redistribute(mesh, x.placements), aux
        y_shared = self._shared_sharded(x)
        return (y.redistribute(mesh, y_shared.placements) + y_shared).redistribute(
            mesh, x.placements), aux

    def _shared_sharded(self, x: DTensor) -> DTensor:
        """The shared experts on each rank's own rows of x, their hidden dim
        split as their specs say → their output, a partial sum over that
        split."""
        mesh = x.device_mesh
        ws = (self.shared_gate, self.shared_up, self.shared_down)
        f_axes = tuple(a for a, p in zip(mesh.mesh_dim_names, ws[0].placements)
                       if isinstance(p, Shard))
        rows = tuple(a for a, p in zip(mesh.mesh_dim_names, x.placements) if isinstance(p, Shard))
        out_pl = cores.partial_over(mesh, f_axes, tuple(x.placements))

        def core(xl, sg, su, sd):
            return shared_experts(xl.reshape(-1, xl.shape[-1]), sg, su, sd).view(xl.shape)

        return local_map(core, out_placements=(out_pl,),
                         in_placements=(tuple(x.placements),) + tuple(w.placements for w in ws),
                         in_grad_placements=(out_pl,) + tuple(
                             cores.partial_over(mesh, rows, w.placements) for w in ws),
                         device_mesh=mesh, redistribute_inputs=True)(x, *ws)

    def params(self) -> dict:
        """The reference's parameter dict of this layer (the tensors
        themselves, or this rank's shards of them)."""
        names = ("router", "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
                 "shared_down")
        return {k: getattr(self, k) for k in names if getattr(self, k) is not None}

    def _alltoall(self, x: torch.Tensor, mesh):
        if not isinstance(x, DTensor):  # a rank's own batch slice and expert shards
            return apply_moe_alltoall(self.params(), x, self.cfg, mesh)
        params = self.params()
        names = list(params)
        batch = expert_placements("x", mesh)
        in_pl = tuple(expert_placements(k, mesh) for k in names) + (batch,)
        def shares(k):  # the axes over which a rank's gradient of k is its share
            if k == "router":
                return mesh.mesh_dim_names
            return shard_ctx.batch_axes_of(mesh) if k.startswith("shared") else ()

        grad_pl = tuple(cores.partial_over(mesh, shares(k), pl)
                        for k, pl in zip(names, in_pl[:-1])) + (batch,)
        fn = local_map(
            lambda *a: apply_moe_alltoall(dict(zip(names, a[:-1])), a[-1], self.cfg, mesh),
            out_placements=(batch, (Replicate(),) * mesh.ndim), in_placements=in_pl,
            in_grad_placements=grad_pl, device_mesh=mesh, redistribute_inputs=True)
        return fn(*params.values(), x)


# ---------------------------------------------------------------------------
# The expert-parallel form: the reference's shard_map ``apply_moe_alltoall``.
# ---------------------------------------------------------------------------
def uses_alltoall(cfg, mesh, x: torch.Tensor) -> bool:
    """The reference's dispatch rule: ``impl == "alltoall"``, a mesh set,
    the experts dividing its ``data`` axis, and the batch dividing the batch
    axes (a rank's own slice always does)."""
    if getattr(cfg.moe, "impl", "gather") != "alltoall" or mesh is None:
        return False
    if cfg.moe.num_experts % shard_ctx.axis_size(mesh, "data"):
        return False
    shards = math.prod(shard_ctx.axis_size(mesh, a) for a in shard_ctx.batch_axes_of(mesh))
    return not isinstance(x, DTensor) or x.shape[0] % shards == 0


#: the reference's shard_map ``in_specs`` (``sharding.specs`` notation)
_IN_SPECS = {
    "router": (None, None),
    "w_gate": ("data", None, "model"),
    "w_up": ("data", None, "model"),
    "w_down": ("data", "model", None),
    "shared_gate": (None, None, "model"),
    "shared_up": (None, None, "model"),
    "shared_down": (None, "model", None),
}


def expert_placements(name: str, mesh) -> tuple:
    """The placements the reference's shard_map ``in_specs`` give the MoE
    tensor ``name`` (``router``, ``w_gate``, ..., ``shared_down``, or
    ``x``, the (B, S, d) input: its batch over the batch axes)."""
    if name == "x":
        bx = shard_ctx.batch_axes_of(mesh)
        return placements((bx if len(bx) > 1 else bx[0], None, None), mesh)
    return placements(_IN_SPECS[name], mesh)


def _slots(n: float) -> int:
    """The reference's slot count: ``int(n)`` rounded up to a multiple of
    8, at least 8."""
    return max(8, -(-int(n) // 8) * 8)


def _positions(ids: torch.Tensor, n_buckets: int, cap: int):
    """ids (N,) (−1: none) → (keep, dest): each id's rows packed into its
    bucket's ``cap`` slots in order; dest ``n_buckets·cap`` is the drop row.
    The reference's ``_dispatch_positions``."""
    valid = ids >= 0
    onehot = F.one_hot(ids.clamp(min=0), n_buckets).to(torch.int32) * valid[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot                        # exclusive
    pos = pos.gather(1, ids.clamp(min=0)[:, None])[:, 0]
    keep = (pos < cap) & valid
    return keep, torch.where(keep, ids * cap + pos, n_buckets * cap)


def _slot_items(dest: torch.Tensor, keep: torch.Tensor, n: int):
    """Which item fills each of ``n`` slots → (item index (n,), 0 where
    the slot is empty; whether it is filled). Filling a buffer by gathering
    the items into their slots keeps it (n, ·): scattering from the items
    would first form one row per item, and the grouped branch has
    T2·E_l of them."""
    items = torch.arange(dest.shape[0], device=dest.device)
    owner = torch.full((n + 1,), -1, dtype=torch.long, device=dest.device)
    owner = owner.scatter(0, torch.where(keep, dest, n), items)[:n]
    return owner.clamp(min=0), owner >= 0


def restrict_to_groups(probs: torch.Tensor, groups: int, keep: int):
    """Node-limited routing (DeepSeek-V3 / K2): the (T, E) probabilities with
    the experts cut into ``groups`` equal groups (the data ranks), zero
    outside each token's ``keep`` groups of the highest expert probability
    → (restricted probabilities, the kept groups (T, keep), best first)."""
    t, e = probs.shape
    gscore = probs.detach().view(t, groups, e // groups).amax(-1)
    _, gsel = route(gscore, keep)
    allowed = torch.zeros(t, groups, dtype=torch.bool, device=probs.device).scatter(1, gsel, True)
    return torch.where(allowed.repeat_interleave(e // groups, dim=1), probs, 0.0), gsel


def apply_moe_alltoall(params: dict, x: torch.Tensor, cfg, mesh, *, traffic=None,
                       stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part of the expert-parallel MoE: ``params`` the rank's
    shards (router (d, E) whole; ``w_gate``/``w_up`` (E_l, d, f_l),
    ``w_down`` (E_l, f_l, d); shared experts split over ``model``), x the
    rank's (b_l, S, d) batch slice → (y (b_l, S, d), aux averaged over the
    batch axes). ``stats``, when given, receives the capacities and the
    assignments kept and dropped at each stage."""
    m = cfg.moe
    bl, s, d = x.shape
    bx = shard_ctx.batch_axes_of(mesh)
    dsize = shard_ctx.axis_size(mesh, "data")
    msize = shard_ctx.axis_size(mesh, "model")
    data = mesh.get_group("data")
    e, e_local, k = m.num_experts, m.num_experts // dsize, m.experts_per_token
    route_groups = m.route_groups if 0 < m.route_groups < dsize else 0
    cf = m.capacity_factor

    tl = bl * s
    xf = x.reshape(tl, d)
    if msize > 1:
        xf = comm.replicated(xf, mesh.get_group("model"))
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)        # (T_l, E)
    if route_groups:
        probs, gsel = restrict_to_groups(probs, dsize, route_groups)
    gate, idx = route(probs, k)

    # load-balance aux, averaged over the batch axes
    me = probs.mean(0)
    ce = F.one_hot(idx, e).float().sum(1).mean(0)
    aux = e * (me * ce).sum() * m.aux_loss_weight
    aux = comm.mean_over(aux, [mesh.get_group(a) for a in bx], mesh.size())

    if "shared_gate" in params:  # partial over f_l
        y_shared = shared_experts(xf, params["shared_gate"], params["shared_up"],
                                  params["shared_down"])

    def experts(hidden):                                 # partial over f_l
        return routed_experts(hidden, params["w_gate"], params["w_up"], params["w_down"])

    if route_groups:
        # ---- deduplicated dispatch: ONE send per (token, group) ----------
        gmat = torch.zeros(tl, e, device=x.device).scatter(1, idx, gate)
        gm = torch.gather(gmat.view(tl, dsize, e_local), 1,
                          gsel[..., None].expand(tl, route_groups, e_local))
        gm = gm.reshape(tl * route_groups, e_local)                      # (T_l·G, E_l)
        ids1 = gsel.reshape(-1)
        tok_of1 = torch.arange(tl * route_groups, device=x.device) // route_groups
        cap1 = _slots(tl * route_groups / dsize * cf)
        keep1, dest1 = _positions(ids1, dsize, cap1)
        it, full = _slot_items(dest1, keep1, dsize * cap1)
        send = torch.cat([xf[tok_of1[it]], gm[it].to(xf.dtype)], dim=1)
        recv = comm.all_to_all(torch.where(full[:, None], send, 0), data, traffic)
        x_r, g_r = recv[:, :d], recv[:, d:].float()                      # (T2, E_l)
        t2 = dsize * cap1
        # (recv slot, local expert) pairs with a nonzero gate
        ids2 = torch.where(g_r > 0, torch.arange(e_local, device=x.device)[None, :], -1)
        ids2 = ids2.reshape(-1)
        cap2 = _slots(t2 * min(k, e_local) / (route_groups * e_local) * cf)
        keep2, dest2 = _positions(ids2, e_local, cap2)
        it2, full2 = _slot_items(dest2, keep2, e_local * cap2)
        slot_row = it2 // e_local                        # the received row of each slot's pair
        hidden = torch.where(full2[:, None], x_r[slot_row], 0)
        out = experts(hidden.view(e_local, cap2, d)).reshape(e_local * cap2, d)
        wts = torch.where(full2, g_r.reshape(-1)[it2], 0).to(x_r.dtype)
        y_slot = x_r.new_zeros(t2, d).index_add(0, slot_row, out * wts[:, None])
        y_ret = comm.all_to_all(y_slot, data, traffic)
        y_routed = y_ret[dest1.clamp(max=t2 - 1)] * keep1[:, None]
        y = x.new_zeros(tl, d).index_add(0, tok_of1, y_routed.to(x.dtype))
    else:
        # ---- stage 1: one send per (token, expert), exchange -------------
        flat_idx = idx.reshape(-1)
        dest_rank, e_loc = flat_idx // e_local, flat_idx % e_local
        tok_of = torch.arange(tl * k, device=x.device) // k
        cap1 = _slots(tl * k / dsize * cf)
        keep1, dest1 = _positions(dest_rank, dsize, cap1)
        it, full = _slot_items(dest1, keep1, dsize * cap1)
        # channel d carries the local-expert id (+1; 0 = an empty slot)
        send = torch.cat([xf[tok_of[it]], (e_loc[it] + 1).to(xf.dtype)[:, None]], dim=1)
        recv = comm.all_to_all(torch.where(full[:, None], send, 0), data, traffic)
        # ---- stage 2: local expert compute -------------------------------
        x_r = recv[:, :d]
        e_r = torch.round(recv[:, d].detach().float()).long() - 1
        t2 = dsize * cap1
        cap2 = _slots(t2 / e_local * cf)
        keep2, dest2 = _positions(e_r, e_local, cap2)
        it2, full2 = _slot_items(dest2, keep2, e_local * cap2)
        hidden = torch.where(full2[:, None], x_r[it2], 0)
        out = experts(hidden.view(e_local, cap2, d)).reshape(e_local * cap2, d)
        y_r = out[dest2.clamp(max=e_local * cap2 - 1)] * keep2[:, None]
        y_ret = comm.all_to_all(y_r, data, traffic)
        y_routed = y_ret[dest1.clamp(max=t2 - 1)]
        w = (gate.reshape(-1) * keep1).to(x.dtype)
        y = x.new_zeros(tl, d).index_add(0, tok_of, y_routed * w[:, None])
    if "shared_gate" in params:
        y = y + y_shared.to(y.dtype)                     # also partial over f_l
    if msize > 1:
        y = comm.sum_over(y, mesh.get_group("model"), traffic)  # one model-axis reduction
    if stats is not None:
        ids2 = ids2 if route_groups else e_r
        stats.update(cap1=cap1, cap2=cap2, dropped1=int((~keep1).sum()),
                     dropped2=int((ids2 >= 0).sum()) - int(keep2.sum()))
    return y.reshape(bl, s, d), aux
