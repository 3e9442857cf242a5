"""The training engine: epochs × minibatches of sparse margin-SGD steps on
bucket-padded tables, the counterpart of the JAX package's ``kge/engine.py``.

* **sampling** — per epoch a permutation of the (cycle-padded) triple store
  and a 1:1 head/tail corruption against the TRUE entity count (virtual rows
  included, bucket-padding rows never). The draws are a seam: the JAX
  package draws with ``jax.random`` inside its scan, which PyTorch cannot
  reproduce, so ``train_scan_graph`` takes them as explicit inputs
  (``draws``) and otherwise draws them from a ``torch.Generator`` on the
  tables' device;
* **sparse updates** — each step touches only the rows its minibatch names.
  ``fused`` runs the ``sparse_update`` kernel (TransE/DistMult): the whole
  epoch of steps in one launch on CUDA tables, as the JAX package scans its
  Pallas step in one compiled program, and the kernel's plain version step
  by step on CPU tables; ``sparse`` runs autograd over the gathered rows in
  a Python loop of steps (every family);
* **bucket padding** — tables round up to ``ENT_BUCKET``/``REL_BUCKET``
  multiples and the triple store to a power-of-two minibatch count, as in
  the JAX package, so the two run the same schedule on the same shapes.

The JAX package's arrays are immutable; here the steps update the padded
working tables **in place**. ``pad_tables`` always copies and
``strip_tables`` always clones, so ``train_epochs_device`` never writes into
the tables it was given, and the tables it returns share no storage with
its working copy. PyTorch runs eagerly, so there is no compiled-scan cache
to count (the JAX package's ``train_scan_cache_size``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.sparse_update import fused_sparse_epoch
from repro_torch.kge.models import (
    KGEModel,
    Params,
    entity_norms,
    margin_loss,
    normalize_entities,
    score_triples,
)

#: bucket granularities of the padded shapes
ENT_BUCKET = 256
REL_BUCKET = 64

#: param keys indexed by entity id; everything else is relation-indexed
ENT_KEYS = ("ent", "ent_p", "ent_im")


def bucket(n: int, granularity: int) -> int:
    """Round ``n`` up to the next multiple of ``granularity`` (min 1 bucket)."""
    return max(granularity, -(-n // granularity) * granularity)


def shape_spec(model: KGEModel) -> KGEModel:
    """The model with its counts zeroed: what a step needs of it (family,
    margin, norm), independent of the padded table sizes."""
    return dataclasses.replace(model, num_entities=0, num_relations=0)


# ---------------------------------------------------------------------------
# steps: each updates the tables of ``params`` in place → (params, loss)
# ---------------------------------------------------------------------------
def sparse_sgd_step(params: Params, spec: KGEModel, pos: torch.Tensor,
                    neg: torch.Tensor, lr: float) -> Tuple[Params, torch.Tensor]:
    """One margin-SGD step by autograd over the gathered rows only, for
    every family. Duplicate rows compose through the unique-row inverse (the
    gather's backward is the segment-sum over occurrences), and each unique
    row gets ``row + (−lr·g)`` once, as the JAX package's ``at[].add``.

    The unique sets are exactly as long as the batch needs: there are no
    fill slots (the JAX package pads to a static size and drops the fills'
    scatter), so nothing has to be masked. ``torch.unique`` syncs with the
    host on a CUDA device; this path is the one for families the kernel
    does not cover."""
    b = pos.shape[0]
    e_occ = torch.cat([pos[:, 0], pos[:, 2], neg[:, 0], neg[:, 2]])
    r_occ = torch.cat([pos[:, 1], neg[:, 1]])
    ue, inv_e = torch.unique(e_occ, return_inverse=True)
    ur, inv_r = torch.unique(r_occ, return_inverse=True)
    rows = {k: ue if k in ENT_KEYS else ur for k in params}
    with torch.enable_grad():
        local = {k: params[k][rows[k]].detach().requires_grad_(True) for k in params}
        sp = score_triples(local, spec, inv_e[:b], inv_r[:b], inv_e[b:2 * b])
        sn = score_triples(local, spec, inv_e[2 * b:3 * b], inv_r[b:], inv_e[3 * b:])
        loss = margin_loss(sp, sn, spec.margin)
        grads = torch.autograd.grad(loss, list(local.values()), allow_unused=True)
    with torch.no_grad():
        for k, g in zip(local, grads):
            if g is not None:
                params[k].index_add_(0, rows[k], -lr * g)
    return params, loss.detach()


def _fused_epoch(params: Params, spec: KGEModel, pos: torch.Tensor, neg: torch.Tensor,
                 lr: float) -> torch.Tensor:
    """All (nb, B, 3) batches of an epoch through the fused kernel, for the
    {ent, rel}-only families → the step losses (nb,)."""
    mode = "dot" if spec.family == "distmult" else ("l2" if spec.norm_ord == 2 else "l1")
    return fused_sparse_epoch(params["ent"], params["rel"], pos, neg, lr, mode=mode,
                              margin=spec.margin)


def _sparse_epoch_steps(params: Params, spec: KGEModel, pos: torch.Tensor,
                        neg: torch.Tensor, lr: float) -> torch.Tensor:
    """The autograd step over each batch in turn → the step losses (nb,)."""
    return torch.stack([sparse_sgd_step(params, spec, pos[i], neg[i], lr)[1]
                        for i in range(pos.shape[0])])


_EPOCHS = {"fused": _fused_epoch, "sparse": _sparse_epoch_steps}


def sparse_epoch(params: Params, spec: KGEModel, pos: torch.Tensor, neg: torch.Tensor,
                 lr: float) -> Tuple[Params, torch.Tensor]:
    """One epoch of sparse steps over pre-built (nb, B, 3) batches, then the
    entity-norm projection: the sparse twin of the dense ``trainer._epoch``.
    Updates ``params`` in place; returns it and the mean step loss."""
    losses = _sparse_epoch_steps(params, spec, pos, neg, lr)
    params["ent"] = normalize_entities(params)["ent"]
    return params, losses.mean()


# ---------------------------------------------------------------------------
# the multi-epoch loop
# ---------------------------------------------------------------------------
def _renorm_rows(params: Params, ids: torch.Tensor, skip: bool) -> Params:
    """Project only the entity rows named by ``ids`` onto the unit ball, in
    place — the sparse twin of ``normalize_entities``. Duplicate ids write
    the same value. ``skip`` leaves the table as it is (epoch 0 must read
    raw rows, exactly like the dense schedule)."""
    if skip:
        return params
    rows = params["ent"][ids]
    params["ent"][ids] = rows / torch.clamp(entity_norms(rows), min=1.0)
    return params


Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def as_device(x, dev: torch.device) -> torch.Tensor:
    """A host array or a tensor as a tensor on ``dev`` (no copy if it is
    one there already)."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.array(x), device=dev)


def draw_epoch(gen: torch.Generator, n_pad: int, nb: int, batch: int,
               num_entities: int) -> Draws:
    """One epoch's draws on the generator's device: (perm (N_pad,),
    corrupt_head (nb, B) bool, rand_ent (nb, B) in [0, num_entities))."""
    dev = gen.device
    perm = torch.randperm(n_pad, generator=gen, device=dev)
    corrupt_head = torch.rand((nb, batch), generator=gen, device=dev) < 0.5
    rand_ent = torch.randint(0, num_entities, (nb, batch), generator=gen, device=dev)
    return perm, corrupt_head, rand_ent


def epoch_batches(triples: torch.Tensor, drawn: Draws,
                  batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One epoch's minibatches from its draws → (pos, neg), each (nb, B, 3)
    and contiguous: the permuted store, and each positive with its head
    (``corrupt_head``) or else its tail replaced by ``rand_ent``."""
    perm, corrupt_head, rand_ent = drawn
    nb = triples.shape[0] // batch
    pos = triples[perm.long()].reshape(nb, batch, 3)
    rand_ent = rand_ent.to(pos.dtype).reshape(nb, batch)
    corrupt_head = corrupt_head.bool().reshape(nb, batch)
    neg = torch.stack([torch.where(corrupt_head, rand_ent, pos[..., 0]),
                       pos[..., 1],
                       torch.where(corrupt_head, pos[..., 2], rand_ent)], dim=-1)
    return pos, neg


def train_scan_graph(
    params: Params,
    triples: torch.Tensor,       # (N_pad, 3) int64, N_pad % batch == 0, cycled
    lr: float,
    num_entities: int,           # true (extended) entity count: the corruption bound
    *,
    spec: KGEModel,
    epochs: int,
    batch: int,
    impl: str,
    renorm: str = "dense",
    draws: Optional[Sequence[Draws]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Params, torch.Tensor]:
    """All epochs × minibatches → (params, per-epoch mean losses). The
    tables of ``params`` are updated in place.

    ``draws`` holds one ``(perm, corrupt_head, rand_ent)`` per epoch (host
    or device arrays, as ``draw_epoch`` lays them out); without it each
    epoch draws from ``generator`` (a fresh default ``torch.Generator`` on
    the tables' device when that is None too).

    ``renorm`` picks the entity-norm projection schedule, as in the JAX
    package: ``dense`` projects the whole table after every epoch;
    ``sparse`` projects, at the start of each epoch but the first, only the
    rows that epoch gathers, and the whole table once at the end.
    """
    if impl not in _EPOCHS:
        raise ValueError(f"unknown step impl {impl!r} {tuple(_EPOCHS)}")
    if renorm not in ("dense", "sparse"):
        raise ValueError(f"unknown renorm schedule {renorm!r} (dense|sparse)")
    run_epoch = _EPOCHS[impl]
    dev = params["ent"].device
    n_pad = triples.shape[0]
    nb = n_pad // batch
    if draws is None and generator is None:
        generator = torch.Generator(device=dev)
    means = []
    for epoch in range(epochs):
        if draws is None:
            drawn = draw_epoch(generator, n_pad, nb, batch, num_entities)
        else:
            drawn = tuple(as_device(x, dev) for x in draws[epoch])
        pos, neg = epoch_batches(triples, drawn, batch)
        if renorm == "sparse":
            touched = torch.cat([pos[..., 0], pos[..., 2], neg[..., 0], neg[..., 2]])
            _renorm_rows(params, touched.reshape(-1), epoch == 0)
        losses = run_epoch(params, spec, pos, neg, lr)
        if renorm == "dense":
            params["ent"] = normalize_entities(params)["ent"]
        means.append(losses.mean())
    if renorm == "sparse":
        params["ent"] = normalize_entities(params)["ent"]
    return params, torch.stack(means)


def resolve_renorm(tri_pad: int, ent_rows: int) -> str:
    """The sparse schedule gathers 4·N_pad rows per epoch, so it only wins
    when that is cheaper than the dense full-table pass."""
    return "sparse" if 4 * tri_pad < ent_rows else "dense"


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
def pad_tables(params: Params, model: KGEModel) -> Tuple[Params, int, int]:
    """Copies of the tables zero-padded up to bucket multiples → (padded
    params, e_pad, r_pad). Padding rows are inert: no triple references
    them, the corruption bound keeps them out of negatives, and the norm
    projection maps zero rows to zero rows."""
    e_pad = bucket(model.num_entities, ENT_BUCKET)
    r_pad = bucket(model.num_relations, REL_BUCKET)
    out = {}
    for k, v in params.items():
        n = max(e_pad if k in ENT_KEYS else r_pad, v.shape[0])
        out[k] = v.new_zeros((n,) + tuple(v.shape[1:]))
        out[k][: v.shape[0]] = v
    return out, e_pad, r_pad


def strip_tables(params: Params, model: KGEModel) -> Params:
    """Drop bucket-padding rows, restoring the logical table shapes. Each
    table is a clone, not a view: a later in-place step must not write
    through it into the padded storage."""
    e, r = model.num_entities, model.num_relations
    return {k: v[: e if k in ENT_KEYS else r].clone() for k, v in params.items()}


def pad_triples(triples: torch.Tensor, batch: int) -> torch.Tensor:
    """Cycle-pad the triple store so the minibatch count is a power of two;
    every padded row is a real triple."""
    n = triples.shape[0]
    nb = max(1, -(-n // batch))
    n_pad = (1 << (nb - 1).bit_length()) * batch
    if n_pad == n:
        return triples
    reps = torch.arange(n_pad - n, device=triples.device) % n
    return torch.cat([triples, triples[reps]])


def train_epochs_device(
    params: Params,
    model: KGEModel,
    triples,                    # (N, 3) host or device ids
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    impl: str,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Draws]] = None,
) -> Tuple[Params, torch.Tensor]:
    """Bucket-pad, run the epochs, strip the padding → (new params with
    logical shapes, per-epoch mean losses), on the device of ``params``.
    The tables passed in are not written."""
    dev = params["ent"].device
    tri = as_device(triples, dev).long()
    b = min(batch_size, tri.shape[0])
    tri = pad_triples(tri, b)
    padded, e_pad, _ = pad_tables(params, model)
    padded, losses = train_scan_graph(
        padded, tri, lr, model.num_entities, spec=shape_spec(model), epochs=epochs,
        batch=b, impl=impl, renorm=resolve_renorm(tri.shape[0], e_pad), draws=draws,
        generator=generator,
    )
    return strip_tables(padded, model), losses
