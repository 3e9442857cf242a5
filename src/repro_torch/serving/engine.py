"""KGE candidate ranking: filtered ranks and streaming top-k over a trained
model — the KGE part of the JAX package's ``serving/engine.py``.

Ranks go through the fused-rank kernel (``kge.eval.streaming_side_counts``);
top-k scores the entity table one chunk at a time through the pairwise
kernel and folds each chunk into a carried top-k, so the (B, E) score
matrix never exists at once.

Tie order matches ``lax.top_k`` over the JAX package's ``[carried, block]``
concatenation: among equal scores the earlier slot wins, so ties go to the
lower entity id and the initial ``(-inf, -1)`` slots win ties among
``-inf``. ``torch.topk`` promises nothing about ties, so the merge ranks
unique int64 keys — the score's order-preserving integer image in the high
32 bits, the reversed slot position in the low 32 — which makes the order
total and the result the same for any chunk size.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.triple_score import pairwise_scores
from repro_torch.kernels.triple_score.ops import exclusion_mask
from repro_torch.kge.eval import streaming_side_counts
from repro_torch.kge.models import lp_query_tails, score_triples
from repro_torch.serving.tables import FilterPack, TableVersion, check_id_range

#: top-k entity chunk on a CUDA device: the kernel's own tiles bound its
#: working set, so the chunk only bounds the (B, chunk) float32 score slab
#: (16 MB at B = 64) and sets the number of launches per batch
CUDA_TOPK_CHUNK = 1 << 16


class KGECandidateRanker:
    """Serving-side link prediction: filtered ranks and streaming top-k
    candidates. The known-true filter is packed once into a ``FilterPack``
    and sliced per batch; non-finite-row validation is a bitmask lookup
    against the active ``TableVersion``. ``swap()`` switches to a newly
    published version between requests (the filter pack carries over)."""

    def __init__(self, params, model, known_triples=None, *, block_e: int = 2048,
                 filters: Optional[FilterPack] = None):
        self.model = model
        self.block_e = block_e
        self.filters = (
            filters if filters is not None
            else FilterPack(known_triples, model.num_entities)
        )
        self._tv = TableVersion(params, model, self.filters, version=0)

    @property
    def params(self):
        return self._tv.params

    @property
    def version(self) -> int:
        return self._tv.version

    def swap(self, params, *, version: Optional[int] = None) -> TableVersion:
        """Atomically switch to a new table version."""
        v = self._tv.version + 1 if version is None else int(version)
        self._tv = TableVersion(
            params, self.model, self.filters, version=v, owner=self._tv.owner
        )
        return self._tv

    def _check_query(self, h: np.ndarray, r: np.ndarray) -> None:
        """A NaN/Inf row poisons every rank it touches, so a query that
        would serve from one is refused up front with the id named."""
        self._tv.check_finite("entity", self._tv.ent_bad, h)
        self._tv.check_finite("relation", self._tv.rel_bad, r)

    def rank_filter(self, h: np.ndarray, r: np.ndarray, t: np.ndarray) -> np.ndarray:
        """(B, width+1) int32 filter for rank queries: the gold tail in
        column 0 plus the known row (duplicates are harmless — the kernel's
        exclusion is a membership test)."""
        return np.concatenate(
            [np.asarray(t, np.int32)[:, None], self.filters.rows_for(h, r)], axis=1,
        )

    def rank_tails(self, h, r, t) -> np.ndarray:
        """Filtered rank of each gold tail among all entities — (B,) int32."""
        h = check_id_range("head entity", h, self.model.num_entities)
        t = check_id_range("tail entity", t, self.model.num_entities)
        r = check_id_range("relation", r, self.model.num_relations)
        self._check_query(h, r)
        chunk = np.stack([h, r, t], axis=1)
        counts = streaming_side_counts(
            self.params, self.model, chunk, self.rank_filter(h, r, t),
            side="tail", block_e=self.block_e,
        )
        return counts + 1

    def topk_tails(self, h, r, k: int = 10, *, exclude_known: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k candidate tails for (h, r, ·) queries → (ids, scores),
        each (B, k)."""
        h_np = check_id_range("head entity", h, self.model.num_entities)
        r_np = check_id_range("relation", r, self.model.num_relations)
        self._check_query(h_np, r_np)
        dev = self.params["ent"].device
        if exclude_known:
            filt = self.filters.rows_for(h_np, r_np)
        else:
            filt = np.full((len(h_np), 1), -1, np.int32)
        vals, ids = topk_tails_dispatch(
            self.params, self.model, torch.as_tensor(h_np, device=dev),
            torch.as_tensor(r_np, device=dev), torch.as_tensor(filt, device=dev),
            k=k, block_e=self.block_e,
        )
        return ids.cpu().numpy(), vals.cpu().numpy()


def _ordered_keys(vals: torch.Tensor) -> torch.Tensor:
    """(B, n) float32 → (B, n) int64 keys, unique per row, ordered by score
    descending and then by slot ascending: ``torch.topk`` of the keys is the
    stable ``lax.top_k`` of the scores."""
    v = (vals + 0.0).contiguous()  # -0.0 → +0.0: they tie as floats
    bits = v.view(torch.int32).long()
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.arange(vals.shape[1], dtype=torch.int64, device=vals.device)
    return ordered * (1 << 32) + ((1 << 32) - 1 - pos)


def _topk_scan(score_block: Callable[[int, int], torch.Tensor], b: int, e: int,
               filt: torch.Tensor, *, k: int, chunk: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared blockwise top-k merge: carry (vals, ids), fold in one entity
    chunk at a time. ``score_block(c0, c1) → (B, c1−c0)`` scores; filtered
    ids score ``-inf``."""
    kk = min(k, e)
    vals = torch.full((b, kk), float("-inf"), dtype=torch.float32, device=device)
    ids = torch.full((b, kk), -1, dtype=torch.int32, device=device)
    for c0 in range(0, e, chunk):
        c1 = min(c0 + chunk, e)
        s = score_block(c0, c1).masked_fill(exclusion_mask(filt, c0, c1), float("-inf"))
        cb = torch.arange(c0, c1, dtype=torch.int32, device=device)
        allv = torch.cat([vals, s], 1)
        alli = torch.cat([ids, cb[None].expand(b, -1)], 1)
        _, sel = torch.topk(_ordered_keys(allv), kk, dim=1)
        vals, ids = allv.gather(1, sel), alli.gather(1, sel)
    return vals, ids


def _topk_chunk(block_e: int, device: torch.device) -> int:
    return max(block_e, CUDA_TOPK_CHUNK) if device.type == "cuda" else block_e


def _streaming_topk_decomposed(q, table, filt, *, k: int, block_e: int, mode: str):
    """Top-k of a decomposed query: each chunk scored by the pairwise
    kernel (its plain version on the CPU)."""
    q = q.float().contiguous()

    def score_block(c0, c1):
        return pairwise_scores(q, table[c0:c1], mode=mode, block_e=block_e)

    return _topk_scan(score_block, q.shape[0], table.shape[0], filt, k=k,
                      chunk=_topk_chunk(block_e, q.device), device=q.device)


def _streaming_topk_generic(params, model, h, r, filt, *, k: int, block_e: int):
    """Top-k for families without a decomposition: each block scored by
    index expansion through ``score_triples``."""
    b = h.shape[0]

    def score_block(c0, c1):
        be = c1 - c0
        ids = torch.arange(c0, c1, device=h.device)
        hh = h[:, None].expand(b, be).reshape(-1)
        rr = r[:, None].expand(b, be).reshape(-1)
        tt = ids[None].expand(b, be).reshape(-1)
        return score_triples(params, model, hh, rr, tt).reshape(b, be)

    return _topk_scan(score_block, b, model.num_entities, filt, k=k, chunk=block_e,
                      device=h.device)


def topk_tails_dispatch(params, model, h, r, filt, *, k: int, block_e: int):
    """One asynchronous top-k dispatch (device tensors in and out): the
    decomposed path where the family has one, else the generic path."""
    qd = lp_query_tails(params, model, h, r)
    if qd is not None:
        q, table, mode = qd
        return _streaming_topk_decomposed(q, table, filt, k=k, block_e=block_e,
                                          mode=mode)
    return _streaming_topk_generic(params, model, h, r, filt, k=k, block_e=block_e)
