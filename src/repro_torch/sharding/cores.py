"""The model's cores under a mesh: what the reference's shard_map (or
XLA's partitioner) runs on each device, here on each rank's local shards
through DTensor's ``local_map``.

Everything around them (projections, norms, RoPE, the dense FFN)
propagates as DTensors. The cores cannot: a (B·H)-flattened product over a
dim split on two mesh axes, and a head split that does not divide the
``model`` axis (qwen3's 8 KV heads over 16), are shardings DTensor
refuses, where XLA pads. So each core takes its inputs with the batch over
the batch axes and the heads over ``model`` when they divide it, else
whole on every ``model`` rank:

* ``flash``: full-sequence attention, each rank's local heads through the
  flash-attention kernel (its plain version on the CPU);
* ``write_prefix``: prefill's K/V into a cache split over heads or over
  the sequence;
* ``decode``: one new token against such a cache; a cache split over the
  sequence is attended piecewise and the pieces combined over ``model``
  (a running max, the exp-sums and the weighted values, all-reduced);
  ``attend_memory`` the same against whisper's cross-attention memory;
* ``cross_entropy``: the loss over vocabulary-split logits, reduced over
  the vocabulary's pieces as the reference's XLA program reduces them;
* ``embedding``: the lookup in a vocabulary-split table;
* ``ssd``: the Mamba2 SSD through its chunk kernel, every head on each
  ``model`` rank;
* ``per_rows``: a row-wise function of whole parameters (a frontend
  stub's projection, the Mamba2 causal conv).

A core declares, beside each input's placements, its gradient's: a tensor
that each rank used only in part (K/V whole on every ``model`` rank, a
replicated weight applied to the rank's own rows) has a partial gradient.
The MoE's two forms under a mesh (``models.moe``) are such cores too.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.sharding import comm
from repro_torch.sharding import context as shard_ctx

def _split(mesh, dims: dict) -> Tuple:
    """Placements with mesh axis ``a`` splitting tensor dim ``dims[a]``."""
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names)


def partial_over(mesh, axes, like=None) -> Tuple:
    """``like``'s placements (default: whole) with ``axes`` made partial
    sums: the gradient of a tensor each of those ranks used on its own
    share of the work."""
    like = like or (Replicate(),) * mesh.ndim
    return tuple(Partial() if a in axes else p for a, p in zip(mesh.mesh_dim_names, like))


def _batch_dims(mesh, batched: bool) -> dict:
    return {a: 0 for a in shard_ctx.batch_axes_of(mesh)} if batched else {}


def heads_split(n: int, mesh) -> bool:
    return n % shard_ctx.axis_size(mesh, "model") == 0


def split_heads(proj: DTensor, n: int, dh: int) -> DTensor:
    """(..., n·dh) → (..., n, dh); a head split that does not divide the
    ``model`` axis is gathered first (every ``model`` rank holds all
    heads)."""
    mesh = proj.device_mesh
    if not heads_split(n, mesh):
        pl = [Replicate() if isinstance(p, Shard) and p.dim in (-1, proj.ndim - 1) else p
              for p in proj.placements]
        proj = proj.redistribute(mesh, pl)
    return proj.reshape(*proj.shape[:-1], n, dh)


def _kv_for_local_heads(k: torch.Tensor, h: int, n_kv: int, mesh) -> torch.Tensor:
    """k (B, T, KV, Dh) whole on this rank → the KV heads its ``h`` local
    query heads (a ``model`` slice of the H = ``h``·model heads) read."""
    msize = shard_ctx.axis_size(mesh, "model")
    group = h * msize // n_kv                         # query heads per KV head
    m = mesh.get_local_rank("model")
    lo, hi = m * h // group, -(-(m + 1) * h // group)
    if h % (hi - lo):
        raise ValueError(f"{h} local query heads do not map onto {hi - lo} KV heads")
    return k[:, :, lo:hi]


def flash(q: DTensor, k: DTensor, v: DTensor, *, causal: bool, window: int) -> DTensor:
    """q (B, S, H, Dh), k/v (B, T, KV, Dh) DTensors → the context (B, S, H,
    Dh): each rank runs the flash kernel on its batch rows and heads."""
    mesh = q.device_mesh
    h, n_kv = q.shape[2], k.shape[2]
    q_heads = heads_split(h, mesh)
    kv_heads = q_heads and heads_split(n_kv, mesh)
    batch = _batch_dims(mesh, True)
    q_pl = _split(mesh, {**batch, **({"model": 2} if q_heads else {})})
    kv_pl = _split(mesh, {**batch, **({"model": 2} if kv_heads else {})})

    def core(ql, kl, vl):
        if q_heads and not kv_heads:
            kl = _kv_for_local_heads(kl, ql.shape[2], n_kv, mesh)
            vl = _kv_for_local_heads(vl, ql.shape[2], n_kv, mesh)
        out = flash_ops.flash_attention(ql.transpose(1, 2), kl.transpose(1, 2),
                                        vl.transpose(1, 2), causal=causal, window=window)
        return out.transpose(1, 2)

    # K/V whole on every model rank serve only the local heads' KV heads there
    kv_grad = partial_over(mesh, ("model",), kv_pl) if q_heads and not kv_heads else kv_pl
    return local_map(core, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _seq_axes(cache: DTensor) -> Tuple[str, ...]:
    """The mesh axes that split a (B, T, KV, Dh) cache's sequence, major
    to minor (``model``, or with a batch of one the data axes too)."""
    return tuple(a for a, p in zip(cache.device_mesh.mesh_dim_names, cache.placements)
                 if isinstance(p, Shard) and p.dim == 1)


def _row_offset(cache: DTensor, local_t: int) -> int:
    """The first cache position this rank holds."""
    mesh, i = cache.device_mesh, 0
    for a in _seq_axes(cache):
        i = i * shard_ctx.axis_size(mesh, a) + mesh.get_local_rank(a)
    return i * local_t


def write_prefix(cache: DTensor, kv: DTensor) -> None:
    """``cache[:, :S] = kv`` for a (B, T, KV, Dh) cache split over heads or
    over the sequence; kv (B, S, KV, Dh)."""
    kv_pl = tuple(Replicate() if isinstance(c, Shard) and c.dim == 1 else c
                  for c in cache.placements)
    s = kv.shape[1]

    def core(cl, kl):
        lo = _row_offset(cache, cl.shape[1])
        hi = min(s, lo + cl.shape[1])
        if hi > lo:
            cl[:, :hi - lo] = kl[:, lo:hi].to(cl.dtype)
        return cl

    local_map(core, out_placements=(cache.placements,), in_placements=(cache.placements, kv_pl),
              device_mesh=cache.device_mesh, redistribute_inputs=True)(cache, kv)


def _decode_placements(q: DTensor, cache: DTensor):
    """(q's placements for the core, whether the cache is split over the
    batch, the groups its sequence is split over)."""
    mesh = q.device_mesh
    heads = any(isinstance(p, Shard) and p.dim == 2 for p in cache.placements)
    batched = any(isinstance(p, Shard) and p.dim == 0 for p in cache.placements)
    q_pl = _split(mesh, {**_batch_dims(mesh, batched), **({"model": 2} if heads else {})})
    return q_pl, batched, [mesh.get_group(a) for a in _seq_axes(cache)]


def decode(body, q: DTensor, k1: DTensor, v1: DTensor, cache: dict, pos: torch.Tensor,
           window: int) -> DTensor:
    """One token per row: q (B, 1, H, Dh), k1/v1 (B, 1, KV, Dh) DTensors,
    ``pos`` (B,) each row's position (a plain tensor, the same on every
    rank) → the context (B, 1, H, Dh). ``body`` (``attention.decode_one``)
    writes k1/v1 into each rank's piece of the cache at ``pos`` and attends
    keys ``t ≤ pos`` (within the window)."""
    mesh = q.device_mesh
    ck, cv = cache["k"], cache["v"]
    q_pl, batched, groups = _decode_placements(q, ck)
    pos_rep = DTensor.from_local(pos, mesh, (Replicate(),) * mesh.ndim, run_check=False)

    def core(ql, kl, vl, ckl, cvl, pl):
        if batched:
            pl = pl.view(-1, ql.shape[0])[_batch_rank(mesh)]
        return body(ql, kl, vl, ckl, cvl, pl, window, lo=_row_offset(ck, ckl.shape[1]),
                    groups=groups)

    return local_map(core, out_placements=(q_pl,),
                     in_placements=(q_pl, q_pl, q_pl, ck.placements, ck.placements,
                                    (Replicate(),) * mesh.ndim),
                     device_mesh=mesh, redistribute_inputs=True)(q, k1, v1, ck, cv, pos_rep)


def attend_memory(body, q: DTensor, memory: dict) -> DTensor:
    """One query per row against every row of a cross-attention memory
    (B, T, KV, Dh): the encoder's K/V that decode reads (whisper), through
    ``body`` (``attention.attend_one``)."""
    mesh = q.device_mesh
    mk, mv = memory["k"], memory["v"]
    q_pl, _, groups = _decode_placements(q, mk)

    def core(ql, kl, vl):
        return body(ql, kl, vl, None, groups)

    return local_map(core, out_placements=(q_pl,),
                     in_placements=(q_pl, mk.placements, mv.placements),
                     device_mesh=mesh, redistribute_inputs=True)(q, mk, mv)


def _batch_rank(mesh) -> int:
    """This rank's index over the batch axes, major to minor."""
    i = 0
    for a in shard_ctx.batch_axes_of(mesh):
        i = i * shard_ctx.axis_size(mesh, a) + mesh.get_local_rank(a)
    return i


def cross_entropy(logits: DTensor, labels: DTensor, mask: DTensor, z_loss: float):
    """``train.loss``'s masked CE sums over DTensors: logits (N, V) fp32 with
    the rows over the batch axes and the vocabulary over ``model`` (or
    whole), labels and mask (N,) → (sum of the masked NLL, z_loss · sum of
    the masked lse²), each a 0-d DTensor. The log-sum-exp and the picked
    logit are reduced over the vocabulary's pieces (a max, then sums), not
    gathered."""
    mesh = logits.device_mesh
    model = mesh.get_group("model")
    split = isinstance(logits.placements[mesh.mesh_dim_names.index("model")], Shard)
    batch = _batch_dims(mesh, True)
    rows = _split(mesh, batch)
    l_pl = _split(mesh, {**batch, **({"model": 1} if split else {})})
    out_pl = tuple(Partial() if a in batch else Replicate() for a in mesh.mesh_dim_names)

    def core(ll, lab, m):
        v = ll.shape[1]
        lo = mesh.get_local_rank("model") * v if split else 0
        mx = ll.detach().amax(-1)
        if split:
            mx = funcol.wait_tensor(funcol.all_reduce(mx, "max", model))
        se = torch.exp(ll - mx[:, None]).sum(-1)
        inside = (lab >= lo) & (lab < lo + v)
        picked = ll.gather(1, (lab - lo).clamp(0, v - 1).long()[:, None])[:, 0] * inside
        if split:
            se, picked = comm.sum_over(se, model), comm.sum_over(picked, model)
        lse = torch.log(se) + mx
        mf = m.float()
        nll = torch.sum((lse - picked) * mf)
        z = torch.sum(torch.square(lse) * mf) * z_loss if z_loss else nll.new_zeros(())
        return nll, z

    return local_map(core, out_placements=(out_pl, out_pl), in_placements=(l_pl, rows, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels, mask)


def embedding(ids: DTensor, table: DTensor) -> DTensor:
    """``F.embedding(ids, table)`` for a table whose rows (the vocabulary)
    are split over ``model``: each rank looks up the ids in its rows and
    the pieces are summed over ``model`` (DTensor's own lookup leaves a
    masked partial whose gradient does not add to the tied unembedding's)."""
    mesh = table.device_mesh
    model = mesh.get_group("model")
    split = isinstance(table.placements[mesh.mesh_dim_names.index("model")], Shard)
    ids_pl = tuple(ids.placements)

    def core(il, tl):
        v = tl.shape[0]
        lo = mesh.get_local_rank("model") * v if split else 0
        inside = (il >= lo) & (il < lo + v)
        out = F.embedding((il - lo).clamp(0, v - 1), tl) * inside[..., None].to(tl.dtype)
        return comm.sum_over(out, model) if split else out

    rows = tuple(a for a, p in zip(mesh.mesh_dim_names, ids_pl) if isinstance(p, Shard))
    return local_map(core, out_placements=(ids_pl,), in_placements=(ids_pl, table.placements),
                     in_grad_placements=(ids_pl, partial_over(mesh, rows, table.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(ids, table)


def ssd(fn, x: DTensor, dt, A, bm, cm, chunk: int, state=None):
    """``fn(x, dt, A, bm, cm, chunk=, state=)`` (the SSD through its chunk
    kernel) on each rank's batch rows, every head whole on every ``model``
    rank → (y, final state) as DTensors."""
    mesh = x.device_mesh
    rows = _split(mesh, _batch_dims(mesh, True))
    whole = (Replicate(),) * mesh.ndim

    def core(xl, dtl, al, bl, cl, sl):
        return fn(xl, dtl, al, bl, cl, chunk=chunk, state=sl)

    in_pl = (rows, rows, whole, rows, rows, rows if state is not None else None)
    a_grad = partial_over(mesh, shard_ctx.batch_axes_of(mesh))
    return local_map(core, out_placements=(rows, rows), in_placements=in_pl,
                     in_grad_placements=in_pl[:2] + (a_grad,) + in_pl[3:],
                     device_mesh=mesh, redistribute_inputs=True)(x, dt, A, bm, cm, state)


def per_rows(fn, x: DTensor, *params) -> DTensor:
    """``fn(x, *params)`` for an ``fn`` that treats each batch row alone,
    with ``params`` whole on every rank (a frontend stub's projection, the
    Mamba2 causal conv): each rank computes its own rows, and its gradient
    of each parameter is its partial sum over them. (DTensor's own
    propagation turns such a partial gradient into a split of the
    flattened rows over two mesh axes, which its next product refuses,
    and its planner fails on the conv's sequence padding.)"""
    mesh = x.device_mesh
    batch = shard_ctx.batch_axes_of(mesh)
    if x.shape[0] % math.prod(shard_ctx.axis_size(mesh, a) for a in batch):
        batch = ()
    rows = _split(mesh, {a: 0 for a in batch})
    whole = (Replicate(),) * mesh.ndim
    n = len(params)
    return local_map(fn, out_placements=(rows,), in_placements=(rows,) + (whole,) * n,
                     in_grad_placements=(rows,) + (partial_over(mesh, batch),) * n,
                     device_mesh=mesh, redistribute_inputs=True)(x, *params)
