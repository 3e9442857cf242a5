"""Filtered link-prediction rank counts: the serving subset of the JAX
package's ``kge/eval.py``.

Known-true entities are packed once into padded CSR-style index arrays;
queries are decomposed into (query vector, entity table, mode) through
``lp_query_*``, and per-query filtered rank counts come from
``kernels.triple_score.fused_ranks`` — the CUDA kernel on a CUDA device, the
plain streamed version on the CPU — so the (B, E) score matrix never
materializes. Families without a decomposition stream ``score_triples``
one entity block at a time.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.triple_score import fused_ranks
from repro_torch.kernels.triple_score.ops import exclusion_mask
from repro_torch.kge.models import (
    KGEModel,
    lp_gold_scores,
    lp_query_heads,
    lp_query_tails,
    score_triples,
)


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

    hr_t, rt_h = _filter_mask(all_triples, 0)
    tails = [sorted(hr_t[(int(h), int(r))]) for h, r, _ in test]
    heads = [sorted(rt_h[(int(r), int(t))]) for _, r, t in test]
    return pack_padded_filters(tails), pack_padded_filters(heads)


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
                      block_e: int = 512) -> torch.Tensor:
    """Filtered rank counts for one corruption side: device tensors in,
    device tensor out, no host sync. The fused-rank kernel on a CUDA
    device; ``block_e`` sizes the plain and generic blocks."""
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
                         block_e: int = 512) -> torch.Tensor:
    """One asynchronous dispatch of the side-count engine — device tensors
    in, device tensor out, no host sync: the serving tier's batch call. On
    a CUDA device the caller records an event after it and polls it."""
    return side_counts_graph(params, model, h, r, t, filt, side=side,
                             block_e=block_e)
