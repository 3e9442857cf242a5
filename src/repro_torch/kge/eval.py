"""Evaluation: triple classification and (filtered) link prediction.

Triple classification (§4.1.3): corrupt each valid/test triple 1:1, learn
a global score threshold on the valid set, report accuracy on test.

Link prediction: rank the true tail (and head) of each test triple against
all entities, removing other true triples in Filter mode; report Mean Rank
and Hit@1/3/10 — the metrics of Tab. 4 / Tab. 6. ``engine="reference"``
keeps the per-triple ranking over materialized (B, E) score matrices as the
parity oracle.

Known-true entities are packed once into padded CSR-style index arrays;
queries are decomposed into (query vector, entity table, mode) through
``lp_query_*``, and per-query filtered rank counts come from
``kernels.triple_score.fused_ranks`` — the CUDA kernel on a CUDA device, the
plain streamed version on the CPU — so the (B, E) score matrix never
materializes. TransR's rows (L1) are grouped by relation and ranked by
``kernels.triple_score.projected_ranks``, which projects the entity table
per group inside the kernel. Other families without a decomposition stream
``score_triples`` one entity block at a time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.triple_score import fused_ranks, projected_ranks
from repro_torch.kernels.triple_score.ops import exclusion_mask
from repro_torch.kge.data import corrupt_triples
from repro_torch.kge.models import (
    KGEModel,
    lp_gold_scores,
    lp_query_heads,
    lp_query_tails,
    by_relation_group,
    score_all_heads,
    score_all_tails,
    score_triples,
)


def best_threshold_accuracy(pos: np.ndarray, neg: np.ndarray, *,
                            max_candidates: int = 512) -> Tuple[float, float]:
    """(threshold, accuracy) maximizing ((pos ≥ thr) + (neg < thr)) / 2 over
    candidate thresholds — one broadcast (C, N) comparison."""
    cand = np.unique(np.concatenate([pos, neg]))
    if len(cand) > max_candidates:
        cand = cand[:: len(cand) // max_candidates]
    acc = (
        (pos[None, :] >= cand[:, None]).mean(axis=1)
        + (neg[None, :] < cand[:, None]).mean(axis=1)
    ) / 2.0
    best = int(np.argmax(acc))
    return float(cand[best]), float(acc[best])


def triple_classification_accuracy(params, model: KGEModel, kg, *, seed: int = 0) -> float:
    """Accuracy on ``kg.test`` at the threshold learnt on ``kg.valid``, each
    split against one 1:1 corruption drawn from ``seed`` (the same numpy
    draws as the JAX package's). Scores run on the params' device."""
    rng = np.random.default_rng(seed)
    va, te = kg.valid, kg.test
    va_neg = corrupt_triples(rng, va, kg.num_entities)
    te_neg = corrupt_triples(rng, te, kg.num_entities)
    dev = params["ent"].device

    def scores(t):
        t = torch.as_tensor(np.asarray(t, np.int64), device=dev)
        return score_triples(params, model, t[:, 0], t[:, 1], t[:, 2]).cpu().numpy()

    sv_pos, sv_neg = scores(va), scores(va_neg)
    thr, _ = best_threshold_accuracy(sv_pos, sv_neg)
    st_pos, st_neg = scores(te), scores(te_neg)
    return float(((st_pos >= thr).mean() + (st_neg < thr).mean()) / 2.0)


# ---------------------------------------------------------------------------
# filter construction: padded CSR-style known-true index arrays
# ---------------------------------------------------------------------------
def _filter_mask(all_triples: np.ndarray, num_entities: int):
    """Dicts mapping (h, r) → {t} and (r, t) → {h} for Filter mode."""
    hr_t: Dict[Tuple[int, int], set] = {}
    rt_h: Dict[Tuple[int, int], set] = {}
    for h, r, t in all_triples:
        hr_t.setdefault((int(h), int(r)), set()).add(int(t))
        rt_h.setdefault((int(r), int(t)), set()).add(int(h))
    return hr_t, rt_h


def pack_padded_filters(rows, *, width: Optional[int] = None) -> np.ndarray:
    """Pack variable-length known-true id lists into one padded (N, W) int32
    array (pad −1, W ≥ 1). ``width`` pins W; a row longer than ``width`` is
    an error rather than a silent truncation — a dropped filter id would
    silently stop excluding a known-true entity."""
    rows = [np.asarray(x, np.int64).reshape(-1) for x in rows]
    w = max(1, max((len(x) for x in rows), default=1))
    if width is not None:
        if w > width:
            raise ValueError(f"filter row of {w} ids exceeds width {width}")
        w = max(1, width)
    out = np.full((len(rows), w), -1, np.int32)
    for i, x in enumerate(rows):
        out[i, : len(x)] = x
    return out


def build_filter_arrays(
    test: np.ndarray, all_triples: Optional[np.ndarray], *, filtered: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query known-true entity ids as padded (B, F) int32 arrays (pad
    −1) for the tail and head sides. The gold entity is always a member of
    its row (also in raw mode), which makes the rank invariant to
    gather-vs-tile fp noise on the gold score."""
    b = len(test)
    if not filtered:
        filt_t = np.full((b, 1), -1, np.int64)
        filt_h = np.full((b, 1), -1, np.int64)
        filt_t[:, 0] = test[:, 2]
        filt_h[:, 0] = test[:, 0]
        return filt_t.astype(np.int32), filt_h.astype(np.int32)

    known = np.asarray(all_triples, np.int64)
    q = np.asarray(test, np.int64).reshape(-1, 3)
    tails = _known_ids(known[:, :2], known[:, 2], q[:, :2])
    heads = _known_ids(known[:, 1:], known[:, 0], q[:, 1:])
    return pack_padded_filters(tails), pack_padded_filters(heads)


def _known_ids(keys: np.ndarray, ids: np.ndarray, queries: np.ndarray) -> List[np.ndarray]:
    """For each query key (a row of two ids), the sorted distinct ``ids`` of
    the rows of ``keys`` equal to it: what ``_filter_mask``'s sets hold, by
    one sort instead of a Python pass over every triple. A query key that
    no row has raises ``KeyError``, as the dict lookup does."""
    span = int(max(keys[:, 1].max(initial=0), queries[:, 1].max(initial=0))) + 1
    code = keys[:, 0] * span + keys[:, 1]
    order = np.lexsort((ids, code))
    code, ids = code[order], ids[order]
    fresh = np.ones(len(code), bool)
    fresh[1:] = (code[1:] != code[:-1]) | (ids[1:] != ids[:-1])
    code, ids = code[fresh], ids[fresh]
    want = queries[:, 0] * span + queries[:, 1]
    lo, hi = np.searchsorted(code, want, "left"), np.searchsorted(code, want, "right")
    missing = np.flatnonzero(lo == hi)
    if missing.size:
        raise KeyError(tuple(int(x) for x in queries[missing[0]]))
    return [ids[a:b] for a, b in zip(lo, hi)]


# ---------------------------------------------------------------------------
# streaming rank engine
# ---------------------------------------------------------------------------
def generic_counts_graph(params, model: KGEModel, fixed_a, fixed_b, gold, filt, *,
                         side: str, block_e: int) -> torch.Tensor:
    """Rank counts via blockwise ``score_triples`` for families without a
    query/table decomposition; ``side`` is "tail" (fixed h, r) or "head"
    (fixed r, t). Never materializes (B, E)."""
    b = fixed_a.shape[0]
    e = model.num_entities
    gold = gold.float()[:, None]
    counts = torch.zeros(b, dtype=torch.int32, device=fixed_a.device)
    for c0 in range(0, e, block_e):
        c1 = min(c0 + block_e, e)
        be = c1 - c0
        ids = torch.arange(c0, c1, device=fixed_a.device)
        aa = fixed_a[:, None].expand(b, be).reshape(-1)
        bb = fixed_b[:, None].expand(b, be).reshape(-1)
        cc = ids[None].expand(b, be).reshape(-1)
        if side == "tail":
            s = score_triples(params, model, aa, bb, cc)
        else:
            s = score_triples(params, model, cc, aa, bb)
        beats = (s.reshape(b, be) > gold) & ~exclusion_mask(filt, c0, c1)
        counts += beats.sum(1, dtype=torch.int32)
    return counts


def side_counts_graph(params, model: KGEModel, h, r, t, filt, *, side: str,
                      block_e: int = 512, groups=None) -> torch.Tensor:
    """Filtered rank counts for one corruption side: device tensors in,
    device tensor out, no host sync. The fused-rank kernel on a CUDA
    device, the projected-rank kernel for TransR (``groups``, the batch's
    ``relation_groups(r)``, where the caller has them); ``block_e`` sizes
    the plain and generic blocks."""
    if by_relation_group(model):
        fixed, gold = (h, t) if side == "tail" else (t, h)
        return projected_ranks(params["ent"], params["proj"], params["rel"], fixed, gold, r,
                               filt, side=side, groups=groups, block_e=block_e)
    qd = (
        lp_query_tails(params, model, h, r)
        if side == "tail"
        else lp_query_heads(params, model, r, t)
    )
    if qd is not None:
        q, table, mode = qd
        gold = lp_gold_scores(q, table, t if side == "tail" else h, mode)
        return fused_ranks(q, table, gold, filt, mode=mode, block_e=block_e)
    gold = score_triples(params, model, h, r, t)
    fixed = (h, r) if side == "tail" else (r, t)
    return generic_counts_graph(params, model, *fixed, gold, filt, side=side,
                                block_e=block_e)


def streaming_side_counts(params, model: KGEModel, chunk: np.ndarray,
                          filt: np.ndarray, *, side: str,
                          block_e: int = 512) -> np.ndarray:
    """Filtered rank counts for ONE corruption side, host in, host out:
    ``chunk`` (B, 3) test triples and ``filt`` (B, F) known-true ids for
    this side (pad −1) go to the params' device in one copy each."""
    dev = params["ent"].device
    tri = torch.as_tensor(np.asarray(chunk, np.int64), device=dev)
    f = torch.as_tensor(np.asarray(filt, np.int32), device=dev)
    counts = side_counts_graph(params, model, tri[:, 0], tri[:, 1], tri[:, 2], f,
                               side=side, block_e=block_e)
    return counts.cpu().numpy()


def side_counts_dispatch(params, model: KGEModel, h, r, t, filt, *, side: str,
                         block_e: int = 512, groups=None) -> torch.Tensor:
    """One asynchronous dispatch of the side-count engine — device tensors
    in, device tensor out, no host sync: the serving tier's batch call. On
    a CUDA device the caller records an event after it and polls it."""
    return side_counts_graph(params, model, h, r, t, filt, side=side,
                             block_e=block_e, groups=groups)


def build_score_inputs(kg, *, split: str = "test", max_test: int = 2000,
                       filtered: bool = True) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(test, filt_t, filt_h) for ``link_prediction(..., precomputed=...)``:
    the split arrays are immutable, so build these once per (kg, split,
    max_test) and reuse them across evaluations."""
    test = np.asarray(getattr(kg, split))[:max_test]
    all_triples = np.concatenate([kg.train, kg.valid, kg.test]) if filtered else None
    filt_t, filt_h = build_filter_arrays(test, all_triples, filtered=filtered)
    return test, filt_t, filt_h


def streaming_rank_counts(params, model: KGEModel, chunk: np.ndarray, filt_t: np.ndarray,
                          filt_h: np.ndarray, *, block_e: int = 512
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Filtered rank counts (tail, head) for one chunk."""
    return (
        streaming_side_counts(params, model, chunk, filt_t, side="tail", block_e=block_e),
        streaming_side_counts(params, model, chunk, filt_h, side="head", block_e=block_e),
    )


def _metrics(ranks: np.ndarray) -> Dict[str, float]:
    ranks = ranks.astype(np.float64)
    return {
        "mean_rank": float(ranks.mean()),
        "hit@1": float((ranks <= 1).mean()),
        "hit@3": float((ranks <= 3).mean()),
        "hit@10": float((ranks <= 10).mean()),
    }


def link_prediction(params, model: KGEModel, kg, *, filtered: bool = True,
                    max_test: int = 2000, batch: int = 128, split: str = "test",
                    engine: str = "auto", block_e: int = 512,
                    precomputed: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
                    ) -> Dict[str, float]:
    """Filtered/raw link prediction. ``engine``: "auto" | "fused" |
    "reference". "auto" and "fused" count ranks through the fused-rank
    kernel (its plain version on the CPU), ``batch`` test triples at a time;
    "reference" ranks each triple on materialized (B, E) score matrices.
    ``precomputed`` takes a ``build_score_inputs(...)`` triple and skips
    building the test slice and its filters."""
    if engine not in ("auto", "fused", "reference"):
        raise ValueError(f"unknown engine {engine!r} (auto|fused|reference)")
    if precomputed is not None and engine != "reference":
        test, filt_t, filt_h = precomputed
    else:
        test = np.asarray(getattr(kg, split))[:max_test]
        all_triples = np.concatenate([kg.train, kg.valid, kg.test]) if filtered else None
        if engine == "reference":
            return _link_prediction_reference(params, model, kg, test, all_triples,
                                              filtered=filtered, batch=batch)
        filt_t, filt_h = build_filter_arrays(test, all_triples, filtered=filtered)
    ranks = np.empty(2 * len(test), dtype=np.int64)
    for i in range(0, len(test), batch):
        chunk = test[i: i + batch]
        c_tail, c_head = streaming_rank_counts(params, model, chunk, filt_t[i: i + batch],
                                               filt_h[i: i + batch], block_e=block_e)
        # interleaved as the reference loop: tail rank, then head rank
        ranks[2 * i: 2 * (i + len(chunk)): 2] = c_tail + 1
        ranks[2 * i + 1: 2 * (i + len(chunk)): 2] = c_head + 1
    return _metrics(ranks)


def _link_prediction_reference(params, model: KGEModel, kg, test, all_triples, *,
                               filtered: bool, batch: int) -> Dict[str, float]:
    """The oracle: (B, E) score matrices on the host and per-triple ranking."""
    hr_t, rt_h = _filter_mask(all_triples, kg.num_entities) if filtered else ({}, {})
    dev = params["ent"].device
    ranks = []
    for i in range(0, len(test), batch):
        chunk = test[i: i + batch]
        h, r, t = (torch.as_tensor(np.asarray(chunk[:, j], np.int64), device=dev)
                   for j in range(3))
        s_tail = score_all_tails(params, model, h, r).cpu().numpy()
        s_head = score_all_heads(params, model, r, t).cpu().numpy()
        for j, (hh, rr, tt) in enumerate(chunk):
            row = s_tail[j].copy()
            if filtered:
                for other_t in hr_t.get((int(hh), int(rr)), ()):
                    if other_t != int(tt):
                        row[other_t] = -np.inf
            ranks.append(1 + int((row > row[int(tt)]).sum()))
            row = s_head[j].copy()
            if filtered:
                for other_h in rt_h.get((int(rr), int(tt)), ()):
                    if other_h != int(hh):
                        row[other_h] = -np.inf
            ranks.append(1 + int((row > row[int(hh)]).sum()))
    return _metrics(np.array(ranks))
