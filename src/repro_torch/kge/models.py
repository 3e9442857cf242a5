"""KGE model families on PyTorch tensors: TransE, TransH, TransR, TransD,
plus DistMult/ComplEx/RotatE.

Params are a dict of float32 tensors on one device, as the JAX package's
are a dict of arrays; FKGE only ever touches ``params["ent"]`` /
``params["rel"]``. Score convention: **higher is better** (distances are
negated).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.triple_score.ops import sqrt_rn

MODEL_FAMILIES = ("transe", "transh", "transr", "transd", "distmult", "complex", "rotate")
#: families whose link prediction projects the entity table through one
#: d x d matrix per relation (``params["proj"]``): their queries are served
#: relation group by relation group
PROJECTED_FAMILIES = ("transr",)

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class KGEModel:
    family: str
    num_entities: int
    num_relations: int
    dim: int
    margin: float = 4.0
    norm_ord: int = 1  # L1 per OpenKE default for TransE-family


def by_relation_group(m: KGEModel) -> bool:
    """Whether link prediction goes relation group by relation group: TransR
    under L1, whose filtered ranks the projected-rank kernel
    (``kernels.triple_score.projected_ranks``) counts and whose top-k
    projects the entity table once a group. Other norms index-expand."""
    return m.family in PROJECTED_FAMILIES and m.norm_ord == 1


def _generator(seed_or_gen: Union[int, torch.Generator], device: torch.device
               ) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator(device=device).manual_seed(int(seed_or_gen))


def _uniform(gen, shape, lo, hi, device):
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * (hi - lo) + lo).to(device)


def init_kge(seed_or_gen: Union[int, torch.Generator], m: KGEModel, *,
             device=None) -> Params:
    """Fresh tables drawn uniform in ±6/√d (RotatE phases in ±π), as the
    JAX package's ``init_kge``. ``seed_or_gen`` is a seed (a generator on
    ``device`` is made from it) or a ``torch.Generator``; the tables land
    on ``device`` (the current CUDA device by default)."""
    device = resolve_device(device)
    gen = _generator(seed_or_gen, device)
    e, r, d = m.num_entities, m.num_relations, m.dim
    b = 6.0 / math.sqrt(d)

    def uni(shape):
        return _uniform(gen, shape, -b, b, device)

    p = {"ent": uni((e, d)), "rel": uni((r, d))}
    if m.family == "transh":
        w = uni((r, d))
        p["norm_vec"] = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-9)
    elif m.family == "transr":
        eye = torch.eye(d, dtype=torch.float32, device=device)
        p["proj"] = eye[None].repeat(r, 1, 1) + 0.01 * uni((r, d, d))
    elif m.family == "transd":
        p["ent_p"] = uni((e, d))
        p["rel_p"] = uni((r, d))
    elif m.family == "complex":
        p["ent_im"] = uni((e, d))
        p["rel_im"] = uni((r, d))
    elif m.family == "rotate":
        p["rel"] = _uniform(gen, (r, d // 2), -math.pi, math.pi, device)
    return p


def params_from_numpy(params: Mapping[str, np.ndarray], device=None) -> Params:
    """Carry tables across from numpy (e.g. ``{k: np.asarray(v)}`` of the
    JAX package's params): contiguous float32 tensors on ``device``."""
    device = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")).to(device)
        for k, v in params.items()
    }


class _AbsJax(torch.autograd.Function):
    """``|x|`` whose derivative at ``x = 0`` is +1, as JAX's: ``lax.abs``
    differentiates as ``select(x >= 0, g, −g)``, where PyTorch's ``abs``
    gives 0 there. Exact zeros are common on dyadic tables, so without this
    an L1 step of the autograd paths would differ from the JAX package's."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _norm(x, ord_):
    if ord_ == 1:
        return (_AbsJax.apply(x) if x.requires_grad else x.abs()).sum(-1)
    return sqrt_rn(x.square().sum(-1) + 1e-12)


def score_triples(params: Params, m: KGEModel, h, r, t, *,
                  h_emb: Optional[torch.Tensor] = None,
                  t_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score a batch of (h, r, t) index triples; higher = more plausible.
    ``h_emb``/``t_emb`` optionally override the gathered entity rows."""
    ent, rel = params["ent"], params["rel"]
    he = ent[h] if h_emb is None else h_emb
    te = ent[t] if t_emb is None else t_emb

    if m.family == "transe":
        return -_norm(he + rel[r] - te, m.norm_ord)
    if m.family == "transh":
        re, w = rel[r], params["norm_vec"][r]
        w = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-9)
        hp = he - (w * he).sum(-1, keepdim=True) * w
        tp = te - (w * te).sum(-1, keepdim=True) * w
        return -_norm(hp + re - tp, m.norm_ord)
    if m.family == "transr":
        re, mat = rel[r], params["proj"][r]  # (B,d), (B,d,d)
        hp = torch.einsum("bd,bde->be", he, mat)
        tp = torch.einsum("bd,bde->be", te, mat)
        return -_norm(hp + re - tp, m.norm_ord)
    if m.family == "transd":
        re = rel[r]
        hpv, tpv = params["ent_p"][h], params["ent_p"][t]
        rpv = params["rel_p"][r]
        hp = he + (hpv * he).sum(-1, keepdim=True) * rpv
        tp = te + (tpv * te).sum(-1, keepdim=True) * rpv
        return -_norm(hp + re - tp, m.norm_ord)
    if m.family == "distmult":
        return (he * rel[r] * te).sum(-1)
    if m.family == "complex":
        hre, him = he, params["ent_im"][h]
        tre, tim = te, params["ent_im"][t]
        rre, rim = rel[r], params["rel_im"][r]
        return (
            hre * rre * tre + him * rre * tim + hre * rim * tim - him * rim * tre
        ).sum(-1)
    if m.family == "rotate":
        d2 = he.shape[-1] // 2
        hr, hi = he[..., :d2], he[..., d2:]
        tr, ti = te[..., :d2], te[..., d2:]
        ph = rel[r]
        cr, ci = torch.cos(ph), torch.sin(ph)
        rr = hr * cr - hi * ci
        ri = hr * ci + hi * cr
        return -sqrt_rn((rr - tr).square() + (ri - ti).square() + 1e-12).sum(-1)
    raise ValueError(f"unknown family {m.family!r}")


# ---------------------------------------------------------------------------
# link-prediction query decomposition: score(q, e) factors into a per-query
# vector against a query-independent entity table — −‖q − ent[e]‖ (l1/l2),
# q · ent[e] (dot), or the per-component complex modulus distance over
# [re | im] halves (cl1, RotatE). That is the contract of the triple_score
# kernels. TransR projects the entity table through one matrix per relation
# and ranks relation group by relation group (``PROJECTED_FAMILIES``);
# TransH/D fall back to index expansion. ComplEx ranks against the (E, 2d)
# table [ent | ent_im]; RotatE ranks heads with the inverse rotation t∘r̄.
# ---------------------------------------------------------------------------
def _complex_table(params: Params) -> torch.Tensor:
    return torch.cat([params["ent"], params["ent_im"]], dim=1)


def lp_query_tails(params: Params, m: KGEModel, h, r):
    """(query (B,d), entity table (E,d), mode) for tail ranking, or None."""
    if m.family == "transe":
        q = params["ent"][h] + params["rel"][r]
        return q, params["ent"], ("l2" if m.norm_ord == 2 else "l1")
    if m.family == "distmult":
        return params["ent"][h] * params["rel"][r], params["ent"], "dot"
    if m.family == "complex":
        hre, him = params["ent"][h], params["ent_im"][h]
        rre, rim = params["rel"][r], params["rel_im"][r]
        q = torch.cat([hre * rre - him * rim, him * rre + hre * rim], 1)
        return q, _complex_table(params), "dot"
    if m.family == "rotate":
        he = params["ent"][h]
        d2 = he.shape[-1] // 2
        hr, hi = he[..., :d2], he[..., d2:]
        ph = params["rel"][r]
        cr, ci = torch.cos(ph), torch.sin(ph)
        q = torch.cat([hr * cr - hi * ci, hr * ci + hi * cr], 1)
        return q, params["ent"], "cl1"
    return None


def lp_query_heads(params: Params, m: KGEModel, r, t):
    """(query (B,d), entity table (E,d), mode) for head ranking, or None."""
    if m.family == "transe":
        q = params["ent"][t] - params["rel"][r]
        return q, params["ent"], ("l2" if m.norm_ord == 2 else "l1")
    if m.family == "distmult":
        return params["rel"][r] * params["ent"][t], params["ent"], "dot"
    if m.family == "complex":
        tre, tim = params["ent"][t], params["ent_im"][t]
        rre, rim = params["rel"][r], params["rel_im"][r]
        q = torch.cat([rre * tre + rim * tim, rre * tim - rim * tre], 1)
        return q, _complex_table(params), "dot"
    if m.family == "rotate":
        te = params["ent"][t]
        d2 = te.shape[-1] // 2
        tr, ti = te[..., :d2], te[..., d2:]
        ph = params["rel"][r]
        cr, ci = torch.cos(ph), torch.sin(ph)  # conj rotation: t ∘ r̄
        q = torch.cat([tr * cr + ti * ci, ti * cr - tr * ci], 1)
        return q, params["ent"], "cl1"
    return None


def lp_gold_scores(q: torch.Tensor, ent: torch.Tensor, idx, mode: str) -> torch.Tensor:
    """Gold scores gathered with the SAME expansion the tile uses (l2 is
    the clamped |q|²−2q·e+|e|²), so the gold entity's in-tile score differs
    from its gathered score only by fp noise — and the rank filter always
    lists gold, so that noise never moves a rank."""
    e = ent[idx].float()
    q = q.float()
    if mode == "dot":
        return (q * e).sum(-1)
    if mode == "l2":
        d2 = (q * q).sum(-1) - 2.0 * (q * e).sum(-1) + (e * e).sum(-1)
        return -sqrt_rn(torch.clamp(d2, min=0.0) + 1e-12)
    if mode == "cl1":
        half = q.shape[-1] // 2
        dr, di = q[:, :half] - e[:, :half], q[:, half:] - e[:, half:]
        return -sqrt_rn(dr * dr + di * di + 1e-12).sum(-1)
    return -(q - e).abs().sum(-1)


def _decomposed_scores(q, table, mode: str, m: KGEModel) -> torch.Tensor:
    """(B, d) query × (E, d) table → (B, E), plain broadcast (oracle)."""
    if mode == "dot":
        return q @ table.T
    if mode == "cl1":
        half = q.shape[-1] // 2
        dr = q[:, None, :half] - table[None, :, :half]
        di = q[:, None, half:] - table[None, :, half:]
        return -sqrt_rn(dr * dr + di * di + 1e-12).sum(-1)
    return -_norm(q[:, None, :] - table[None], m.norm_ord)


def score_all_tails(params: Params, m: KGEModel, h, r) -> torch.Tensor:
    """Score (h, r, ·) against every entity → (B, E). Materializes the
    whole matrix: a test oracle, never on the serving path."""
    qd = lp_query_tails(params, m, h, r)
    if qd is not None:
        q, table, mode = qd
        return _decomposed_scores(q, table, mode, m)
    e = m.num_entities
    b = h.shape[0]
    t_all = torch.arange(e, device=h.device)
    hh = h[:, None].expand(b, e).reshape(-1)
    rr = r[:, None].expand(b, e).reshape(-1)
    tt = t_all[None].expand(b, e).reshape(-1)
    return score_triples(params, m, hh, rr, tt).reshape(b, e)


def score_all_heads(params: Params, m: KGEModel, r, t) -> torch.Tensor:
    """Score (·, r, t) against every entity → (B, E); test oracle."""
    qd = lp_query_heads(params, m, r, t)
    if qd is not None:
        q, table, mode = qd
        return _decomposed_scores(q, table, mode, m)
    e = m.num_entities
    b = t.shape[0]
    h_all = torch.arange(e, device=t.device)
    hh = h_all[None].expand(b, e).reshape(-1)
    rr = r[:, None].expand(b, e).reshape(-1)
    tt = t[:, None].expand(b, e).reshape(-1)
    return score_triples(params, m, hh, rr, tt).reshape(b, e)


# ---------------------------------------------------------------------------
# training surface: the loss, the virtual-row pads and the norm projection
# ---------------------------------------------------------------------------
def margin_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                margin: float) -> torch.Tensor:
    """Margin ranking loss ``mean(relu(margin − pos + neg))``."""
    return torch.relu(margin - pos_scores + neg_scores).mean()


def virtual_pad_rows(params: Params, dim: int, n_ent: int, n_rel: int) -> Params:
    """Inert rows appended to the family-specific tables when ``n_ent``
    virtual entities / ``n_rel`` virtual relations extend ``ent``/``rel``:
    zero projections for TransD, unit normals for TransH, identity maps for
    TransR; on the device of ``params["ent"]``."""
    dev = params["ent"].device
    pads: Params = {}
    if "ent_p" in params:
        pads["ent_p"] = torch.zeros((n_ent, dim), dtype=torch.float32, device=dev)
        pads["rel_p"] = torch.zeros((n_rel, dim), dtype=torch.float32, device=dev)
    if "norm_vec" in params:
        padr = torch.ones((n_rel, dim), dtype=torch.float32, device=dev)
        # ``full`` rather than ``tensor``: no host copy, so a captured
        # CUDA graph can hold it
        pads["norm_vec"] = padr / sqrt_rn(torch.full((), float(dim), device=dev))
    if "proj" in params:
        eye = torch.eye(dim, dtype=torch.float32, device=dev)
        pads["proj"] = eye[None].repeat(n_rel, 1, 1)
    return pads


def entity_norms(rows: torch.Tensor) -> torch.Tensor:
    """(n, 1) L2 norms of ``rows``, correctly rounded as XLA's ``sqrt``."""
    return sqrt_rn(rows.square().sum(-1, keepdim=True))


def normalize_entities(params: Params) -> Params:
    """Project entity embeddings onto the unit ball (TransE constraint).
    Returns a new dict whose ``ent`` is a new tensor; the input is left
    as it was."""
    out = dict(params)
    ent = params["ent"]
    out["ent"] = ent / torch.clamp(entity_norms(ent), min=1.0)
    return out
