"""KGEmb-Update — merging PPAT output back into a KG's embedding tables.

Two pieces (§3.2.1 last paragraph + §4.3 Tab. 7):
  * ``kgemb_update``: replace (or average into) the host's aligned-entity
    embeddings with the DP-synthesized ``G(X)``.
  * ``virtual_extension`` (FKGE vs FKGE-simple): the client additionally
    translates the *neighbors* of aligned entities, G(N(X)), which the host
    temporarily adds as virtual entities/relations + their adjacency triples
    for the next local-training round; they are removed afterwards.

The port's trainer writes its tables in place (``set_entity_embeddings``),
so a caller that may have to undo the update takes ``trainer.snapshot()``
first; the snapshot is a copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kge.engine import as_device


def kgemb_update(trainer, aligned_idx: np.ndarray, synthesized: torch.Tensor, *,
                 mode: str = "average") -> None:
    """Write synthesized embeddings for ``aligned_idx`` into ``trainer``.

    mode='replace' → paper's plain replacement; 'average' → FKGE's smoother
    aggregation (Tab. 7 compares aggregation settings).
    """
    if mode == "replace":
        new = synthesized
    elif mode == "average":
        cur = trainer.get_entity_embeddings(aligned_idx)
        new = 0.5 * (cur + as_device(synthesized, cur.device))
    else:
        raise ValueError(f"unknown aggregation mode {mode!r}")
    trainer.set_entity_embeddings(aligned_idx, new)


@dataclass
class VirtualExtension:
    """Bookkeeping to add & later strip virtual rows from a host trainer."""

    n_virtual_ent: int
    n_virtual_rel: int
    extra_triples: np.ndarray  # (M, 3) in the extended id space


def neighbor_structure(kg, aligned_local: np.ndarray, *, max_neighbors: int = 2000
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Client side: N(X) — neighbor entities + joining relations of aligned
    entities, and the adjacency triples (neighbor, relation, aligned).

    Returns (neighbor_ids, relation_ids, rows[neighbor, r, aligned,
    direction]) with ids local to the client KG: first every triple whose
    tail only is aligned (direction 0), then every triple whose head only is
    aligned (direction 1), each in training-split order, cut to
    ``max_neighbors`` rows — the JAX package's order, with its two
    membership scans done by ``np.isin``."""
    tri = np.asarray(kg.train)
    aligned = np.unique(np.asarray(aligned_local, np.int64))
    mask_t = np.isin(tri[:, 2], aligned)
    mask_h = np.isin(tri[:, 0], aligned)
    # triples whose tail is aligned: head is the virtual neighbor
    tail_side = tri[mask_t & ~mask_h].astype(np.int64)
    # triples whose head is aligned: tail is the virtual neighbor (reverse)
    head_side = tri[mask_h & ~mask_t].astype(np.int64)
    if len(tail_side) + len(head_side) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros((0, 4), np.int64)
    rows = np.concatenate([
        np.stack([tail_side[:, 0], tail_side[:, 1], tail_side[:, 2],
                  np.zeros(len(tail_side), np.int64)], 1),
        np.stack([head_side[:, 2], head_side[:, 1], head_side[:, 0],  # neighbor first
                  np.ones(len(head_side), np.int64)], 1),
    ])[:max_neighbors]
    neigh = np.unique(rows[:, 0])
    rels = np.unique(rows[:, 1])
    return neigh, rels, rows


def virtual_structure(client_kg, aligned_client: np.ndarray, aligned_host: np.ndarray,
                      e0: int, r0: int, *, max_neighbors: int = 2000
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The id-space part of a virtual extension: neighbor entity ids, joining
    relation ids (client-local), and the adjacency triples remapped into the
    host id space, where virtual rows occupy ids ``e0..``/``r0..``."""
    neigh, rels, rows = neighbor_structure(client_kg, aligned_client,
                                           max_neighbors=max_neighbors)
    if len(rows) == 0:
        return None
    ent_map = {int(e): e0 + i for i, e in enumerate(neigh)}
    rel_map = {int(r): r0 + i for i, r in enumerate(rels)}
    align_map = {int(c): int(h) for c, h in zip(aligned_client, aligned_host)}

    extra = []
    for n, r, a, direction in rows:
        host_a = align_map[int(a)]
        vn, vr = ent_map[int(n)], rel_map[int(r)]
        if direction == 0:  # (neighbor) -r-> (aligned)
            extra.append((vn, vr, host_a))
        else:  # (aligned) -r-> (neighbor)
            extra.append((host_a, vr, vn))
    return neigh, rels, np.asarray(extra, np.int64)


def virtual_extension(host_trainer, client_trainer, client_kg, aligned_client: np.ndarray,
                      aligned_host: np.ndarray, generate_fn) -> Optional[VirtualExtension]:
    """Extend the host KG with DP-translated virtual entities/relations.

    ``generate_fn`` is the client's DP generator (embeddings → host space);
    only G(N(X)) crosses the boundary, never raw client embeddings. The
    translated rows stay on the device."""
    vs = virtual_structure(
        client_kg, aligned_client, aligned_host,
        host_trainer.model.num_entities, host_trainer.model.num_relations,
    )
    if vs is None:
        return None
    neigh, rels, extra = vs
    v_ent = generate_fn(client_trainer.get_entity_embeddings(neigh))
    v_rel = generate_fn(client_trainer.get_relation_embeddings(rels))
    host_trainer.extend_tables(v_ent, v_rel, extra)
    return VirtualExtension(len(neigh), len(rels), extra)


#: robust-acceptance modes applied to the synthesized aligned rows before
#: the KGEmb update (``FederationScheduler(robust_agg=...)``)
ROBUST_AGG_MODES = ("none", "clip", "median", "trimmed")


def _masked_median(v: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """Median over the first ``n`` rows of ``v`` (dim 0), robust to padded
    tails: masked-out rows sort to +inf past the true rows."""
    s = torch.sort(torch.where(mask, v, torch.inf), dim=0).values
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def robust_rows(cur: torch.Tensor, synth: torch.Tensor, n: int, *, mode: str,
                want_cos: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Robust acceptance over the synthesized aligned-entity rows, on the
    PPAT_BUCKET-padded shapes: rows past ``n`` pass through untouched.

    Statistics are over the per-row deltas (synth − current):

      * ``clip``    — per-row delta-norm clipping at 2× the median norm;
      * ``median``  — coordinate-wise clamp to median ± 3·MAD;
      * ``trimmed`` — coordinate-wise clamp to the 20%-trimmed mean ± 3× the
                      trimmed absolute deviation;
      * ``none``    — identity.

    ``want_cos`` also returns the mean per-row cosine between the host's
    current rows and the raw synthesized rows (the cosine-shift screen);
    else that value is 1. Plain PyTorch on the tensors' device: the JAX
    package computes this outside any Pallas kernel."""
    if mode not in ROBUST_AGG_MODES:
        raise ValueError(f"unknown robust_agg mode {mode!r}")
    nrows = synth.shape[0]
    mask = torch.arange(nrows, device=synth.device) < n
    nf = max(int(n), 1)
    mean_cos = torch.ones((), dtype=synth.dtype, device=synth.device)
    if want_cos:
        num = (cur * synth).sum(1)
        den = torch.linalg.vector_norm(cur, dim=1) * torch.linalg.vector_norm(synth, dim=1) + 1e-12
        mean_cos = torch.where(mask, num / den, 0.0).sum() / nf
    if mode == "none":
        return synth, mean_cos
    colmask = mask[:, None]
    delta = synth - cur
    if mode == "clip":
        dn = torch.linalg.vector_norm(delta, dim=1)
        cap = 2.0 * _masked_median(dn, mask, nf) + 1e-6
        robust = delta * torch.clamp(cap / torch.clamp(dn, min=1e-12), max=1.0)[:, None]
    elif mode == "median":
        med = _masked_median(delta, colmask, nf)
        mad = _masked_median((delta - med).abs(), colmask, nf)
        robust = torch.clamp(delta, med - 3.0 * mad - 1e-6, med + 3.0 * mad + 1e-6)
    else:  # trimmed
        k = nf // 5  # 20% trimmed each side
        s = torch.sort(torch.where(colmask, delta, torch.inf), dim=0).values
        r = torch.arange(nrows, device=synth.device)[:, None]
        keep = (r >= k) & (r < nf - k)
        cnt = max(nf - 2 * k, 1)
        center = torch.where(keep, s, 0.0).sum(0) / cnt
        spread = torch.where(keep, (s - center).abs(), 0.0).sum(0) / cnt
        robust = torch.clamp(delta, center - 3.0 * spread - 1e-6, center + 3.0 * spread + 1e-6)
    return torch.where(colmask, cur + robust, synth), mean_cos
