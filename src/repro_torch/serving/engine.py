"""The serving engines of the JAX package's ``serving/engine.py``.

``ServingEngine`` (at the end of this file) is the LM engine: slot-based
continuous batching over ``CausalLM.prefill``/``decode_step``.

KGE candidate ranking (``KGECandidateRanker``): filtered ranks and streaming
top-k over a trained model.

Ranks go through the fused-rank kernel (``kge.eval.streaming_side_counts``).
Top-k on a CUDA device goes through the fused top-k kernel
(``pairwise_topk``), which selects inside the scoring kernel; on the CPU,
for families without a decomposition and for k above the kernel's cap, it
scores the entity table one chunk at a time and folds each chunk into a
carried top-k (``topk_scan``), so the (B, E) score matrix never exists at
once. Both order ties alike: to the lower entity id, with ``(-inf, -1)`` in
places no unfiltered entity fills.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.triple_score import pairwise_scores, pairwise_topk, pairwise_topk_cap
from repro_torch.kernels.triple_score.ops import topk_scan
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


def _topk_chunk(block_e: int, device: torch.device) -> int:
    return max(block_e, CUDA_TOPK_CHUNK) if device.type == "cuda" else block_e


def _streaming_topk_decomposed(q, table, filt, *, k: int, block_e: int, mode: str):
    """Top-k of a decomposed query: on a CUDA device the fused top-k kernel
    where k fits it; else each chunk scored by the pairwise kernel (its
    plain version on the CPU) and folded by the scan."""
    q = q.float().contiguous()
    if q.device.type == "cuda" and min(k, table.shape[0]) <= pairwise_topk_cap(
            table.shape[1], mode, q.device):
        return pairwise_topk(q, table, filt, k=k, mode=mode)

    def score_block(c0, c1):
        return pairwise_scores(q, table[c0:c1], mode=mode, block_e=block_e)

    return topk_scan(score_block, q.shape[0], table.shape[0], filt, k=k,
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

    return topk_scan(score_block, b, model.num_entities, filt, k=k, chunk=block_e,
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


# ---------------------------------------------------------------------------
# LM serving: continuous batching over the decode step
# ---------------------------------------------------------------------------
@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # perf_counter: latency math (finished_at - submitted_at) must be
    # monotonic; time.time() jumps with NTP/clock adjustments
    submitted_at: float = field(default_factory=time.perf_counter)
    finished_at: Optional[float] = None


class ServingEngine:
    """A fixed pool of ``max_batch`` slots shares one cache. Requests are
    admitted into free slots (a batch-1 prefill writes that slot's cache
    rows), one batched ``decode_step`` advances every slot per tick at each
    slot's own position, and finished slots are recycled without disturbing
    the others. Decoding is greedy (``temperature`` is recorded but, as in
    the JAX engine, not sampled from), so the tokens of a request equal a
    batch-1 ``prefill`` + ``decode_step`` run of its prompt alone.

    ``model`` is a ``CausalLM`` of ``cfg``; it is moved to ``device``
    (``None``: the current CUDA card, which is required unless the CPU is
    asked for). The cache is updated in place. MoE layers route each slot's
    token as its own group (``decode_step(moe_groups="row")``): the JAX
    engine decodes every slot alone under ``vmap``, so capacity counts one
    token and a request's tokens never depend on its neighbours. A VLM
    card's slot is prefilled without patches, yet its length counts
    ``num_patches``, as in the JAX engine: its first decode writes at row
    ``P + num_patches`` and attends the zero rows ``[P, P + num_patches)``.
    Encoder-decoder cards are refused, as the JAX engine refuses them. A
    request whose prompt plus
    ``max_new_tokens`` exceeds ``max_len`` is refused at ``submit`` (the JAX
    engine's ``dynamic_update_slice`` would clamp its writes to the last
    cache row instead). The JAX engine's ``seed`` is left out: greedy
    decoding draws nothing."""

    def __init__(self, model, cfg, *, max_batch: int = 4, max_len: int = 512, device=None):
        if cfg.encoder_layers:
            raise NotImplementedError(
                "continuous batching engine supports decoder-only archs; "
                "use launch/serve.py for enc-dec (whisper)"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len + cfg.num_patches
        self.cache = self.model.init_cache(max_batch, self.max_len)
        self.lengths = np.zeros(max_batch, np.int32)   # tokens in each slot
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.last_token = np.zeros((max_batch, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._next_rid = 0

    # --- public API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, *, max_new_tokens: int = 16,
               temperature: float = 0.0) -> int:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, got shape "
                             f"{prompt.shape}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens + {max_new_tokens} new tokens "
                             f"exceeds max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens, temperature))
        return rid

    def _slot_cache(self, slot: int):
        """Views of one slot's rows of every layer's cache (writes go through)."""
        return [{kind: {k: t[slot:slot + 1] for k, t in c.items()}
                 for kind, c in layer.items()} for layer in self.cache]

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            tokens = torch.as_tensor(req.prompt[None, :], device=self.device, dtype=torch.long)
            logits = self.model.prefill(tokens, self._slot_cache(slot))
            first = int(torch.argmax(logits[0, -1]))
            req.generated.append(first)
            self.slot_req[slot] = req
            self.lengths[slot] = len(req.prompt) + self.cfg.num_patches
            self.last_token[slot, 0] = first

    def _retire(self) -> None:
        for slot, req in enumerate(self.slot_req):
            if req is not None and len(req.generated) >= req.max_new_tokens:
                req.done = True
                req.finished_at = time.perf_counter()
                self.finished.append(req)
                self.slot_req[slot] = None
                self.lengths[slot] = 0

    def step(self) -> int:
        """One engine tick: admit, decode all slots in one batched call,
        retire. Returns the number of active slots decoded."""
        self._admit()
        self._retire()  # a request of max_new_tokens <= 1 is done at prefill
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tok = torch.as_tensor(self.last_token, device=self.device, dtype=torch.long)
        pos = torch.as_tensor(self.lengths, device=self.device, dtype=torch.long)
        logits = self.model.decode_step(tok, self.cache, pos, moe_groups="row")
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy().astype(np.int32)
        for slot in active:
            req = self.slot_req[slot]
            tok_id = int(nxt[slot])
            req.generated.append(tok_id)
            self.lengths[slot] += 1
            self.last_token[slot, 0] = tok_id
        self._retire()
        return len(active)

    def run_until_drained(self, *, max_ticks: int = 1000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished
