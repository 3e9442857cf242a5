"""KGE serving tier: continuous query batching over replicated,
federation-versioned embedding tables — the port of the JAX package's
``serving/tier.py``.

**Continuous request batching** — ``submit_rank``/``submit_topk`` enqueue
validated requests; ``step()`` coalesces the FIFO head into one query batch
(same kind, same top-k bucket), pads the batch to a power-of-two bucket and
slices filters from the precomputed ``FilterPack``. Batches launch
asynchronously on the replica's current CUDA stream; a CUDA event recorded
after each launch is polled (``event.query()``) to collect finished batches
while new ones launch. CPU batches are ready at once.

**Health-aware replica routing** — the active ``TableVersion`` is staged
onto a ring of replica devices (``core.distributed.replica_devices``).
Each batch routes to the healthy replica with the fewest in-flight batches,
tie-broken by lifetime dispatch count. A batch whose collection fails
re-dispatches up to ``retry_limit`` times to a different replica on the
SAME pinned ``TableVersion``, so a retried batch is bit-identical to one
that succeeded first try. ``breaker_fails`` consecutive failures open a
circuit breaker; the replica is re-admitted by a timed probe every
``probe_after`` launches. With ``hedge_after=`` set, the oldest stuck batch
is hedged to a second replica and the first result wins.

**Admission control and shedding** — ``max_queue=`` bounds the submit queue
with a ``TierOverloadError`` reject; a per-request ``deadline=`` sheds
expired requests at coalesce time into a terminal ``shed`` state. Every
submitted request resolves to exactly one of served / shed / failed, and
``run_until_drained`` asserts ``served + shed + failed == submitted``.

**Version hot-swap** — ``publish(params)`` builds an immutable
``TableVersion`` (its own copy of the tables, so training that goes on in
place cannot reach it), stages it onto every replica (zero-copy on the
device the copy sits on) and flips the active pointer between batches.
In-flight batches finish (and retry) on the version they were dispatched
on; ``_dispatch`` re-checks every request against the non-finite bitmask of
the version the batch is pinned to. ``warm_buckets=`` runs each configured
query bucket once per replica at publish, so the kernels are built and
loaded before the first real batch.

**Spans** — while a profiler session records them (``utils.tracing``) the
tier times each batch's ``tier.assemble`` (coalesce, revalidate,
concatenate, filter rows, pad), ``tier.launch`` (replica pick, copies to
the device, kernel enqueue, event record) and ``tier.collect`` (the copy
to the host and the scatter), all carrying the batch's ``seq``, and one
``tier.request`` span per served request from submit to finish. The
collect's ``tier.copy`` child holds the copy alone: it is queued on the
stream behind any batch launched since, so it holds the host until that
batch is done too. A request's four phases —
``queue_ms`` (submit to coalesce), ``host_ms`` (coalesce to launch end),
``inflight_ms`` (launch end to collect start) and ``collect_ms`` (collect
start to finish) — are differences of its own stamps, so they sum to its
``latency``.

**Relation groups** — for a family that projects the entity table per
relation (TransR under L1), ``_dispatch`` sorts the rows of a padded rank
batch by relation on the host (a stable argsort) and ships the order and
the group offsets with the batch, so the projected-rank kernel needs no
device sync to find them; a ``tier.group`` span (child of
``tier.assemble``) times it, and ``stats["relation_groups"]`` sums the
batches' distinct relations. Padded rows repeat row 0 and so join its
group. Other families skip it.

``serve_impl="direct"`` (``REPRO_SERVE_IMPL``) disables coalescing.
``REPRO_SERVE_REPLICAS`` sizes the replica ring; ``serve_faults=`` /
``REPRO_SERVE_FAULTS`` arm the seeded chaos layer (off by default).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import replica_devices
from repro_torch.core.faults import ServeFault, ServeFaultError, ServeFaultPlan
from repro_torch.kernels.dispatch import (
    resolve_serve_faults,
    resolve_serve_impl,
    resolve_serve_replicas,
)
from repro_torch.kernels.triple_score import relation_groups_host
from repro_torch.kge.eval import side_counts_dispatch
from repro_torch.kge.models import by_relation_group
from repro_torch.serving.engine import topk_tails_dispatch
from repro_torch.serving.tables import FilterPack, TableVersion, check_id_range
from repro_torch.utils import tracing


def _pow2_at_least(n: int, floor: int = 1) -> int:
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


class TierOverloadError(RuntimeError):
    """Submit-time admission reject: the queue is at ``max_queue``. Raised
    before the request enters the system, so rejected requests are counted
    in ``stats["rejected"]`` and never take part in served/shed/failed."""


@dataclass
class QueryRequest:
    """One submitted query batch-of-rows; ``result`` lands asynchronously."""

    rid: int
    kind: str                      # "rank" | "topk"
    h: np.ndarray
    r: np.ndarray
    t: Optional[np.ndarray] = None  # rank only
    k: int = 0                      # topk only
    #: seconds of queue budget from submit; expired requests are shed at
    #: coalesce time (never dispatched). ``None`` = wait forever.
    deadline: Optional[float] = None
    submitted_at: float = field(default_factory=time.perf_counter)
    finished_at: Optional[float] = None
    version: Optional[int] = None   # table version that served it
    result: object = None
    error: Optional[Exception] = None
    shed: bool = False
    done: bool = False

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    @property
    def state(self) -> str:
        """``pending`` | ``served`` | ``shed`` | ``failed``."""
        if not self.done:
            return "pending"
        if self.shed:
            return "shed"
        return "failed" if self.error is not None else "served"


class Replica:
    """One device holding the serving tables; load = in-flight batches.
    ``fails`` counts consecutive failures, ``healthy=False`` removes the
    replica from routing until its probe (``probe_at``, a launch sequence
    number) succeeds; ``ewma_s`` tracks smoothed batch latency."""

    def __init__(self, slot: int, device: torch.device):
        self.slot = slot
        self.device = device
        self.inflight = 0
        self.dispatched = 0
        self.fails = 0
        self.healthy = True
        self.probe_at: Optional[int] = None
        self.ewma_s: Optional[float] = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"Replica({self.slot}, {self.device}, inflight={self.inflight}, "
            f"{'healthy' if self.healthy else 'UNHEALTHY'})"
        )


@dataclass
class _InFlight:
    """A dispatched batch: device outputs + how to scatter them back."""

    kind: str
    out: Tuple                      # device tensors
    segs: List[Tuple[QueryRequest, int, int]]  # (request, offset, rows)
    nq: int                         # real (unpadded) query rows
    tv: TableVersion                # version the batch was dispatched on
    replica: Replica
    host_in: Tuple = ()             # padded host arrays (retry/hedge re-launch)
    kb: int = 0                     # topk k bucket
    seq: int = 0                    # tier-wide launch sequence number
    attempts: int = 0               # re-dispatches already consumed
    fault: Optional[ServeFault] = None
    #: when the batch's requests left the queue (``_coalesce``'s clock read)
    coalesced_at: float = 0.0
    #: when its launch was enqueued
    dispatched_at: float = 0.0
    hedge: Optional["_InFlight"] = None
    #: recorded on the replica's stream after the launch; None on the CPU
    event: Optional[object] = None

    def device_ready(self) -> bool:
        return self.event is None or self.event.query()

    def ready(self) -> bool:
        # an injected straggle suppresses readiness for its simulated delay
        if (self.fault is not None and self.fault.kind == "straggle"
                and time.perf_counter() - self.dispatched_at
                < self.fault.delay):
            return False
        return self.device_ready()


class KGEServingTier:
    """Continuously batched, replicated, hot-swappable KGE query serving.

    ``submit_rank(h, r, t)`` / ``submit_topk(h, r, k=)`` return a
    ``QueryRequest`` at once (validation errors raise at submit;
    ``TierOverloadError`` rejects at ``max_queue``); ``step()`` advances the
    admission loop one batch; ``run_until_drained()`` pumps until every
    request is done. ``req.result`` is the (B,) rank array, or an
    ``(ids, scores)`` pair for top-k — bit-identical to a per-call
    ``KGECandidateRanker`` on the same version and device.

    Replicas live on ``devices`` (default: every visible CUDA device, which
    raises without one); ``device=`` is shorthand for a single device.
    """

    def __init__(self, params, model, known_triples=None, *, owner: Optional[str] = None,
                 block_e: int = 2048, serve_impl: Optional[str] = None,
                 replicas: Optional[int] = None, home_slot: int = 0, devices=None,
                 device=None, max_batch: int = 64, min_bucket: int = 8,
                 max_inflight: Optional[int] = None,
                 filters: Optional[FilterPack] = None,
                 warm_buckets: Optional[List[Tuple]] = None,
                 serve_faults=None, retry_limit: int = 1,
                 breaker_fails: int = 3, probe_after: int = 8,
                 hedge_after: Optional[float] = None,
                 max_queue: Optional[int] = None):
        self.model = model
        self.owner = owner
        self.block_e = block_e
        self.serve_impl = resolve_serve_impl(serve_impl)
        self.max_batch = int(max_batch)
        self.min_bucket = int(min_bucket)
        self.filters = (
            filters if filters is not None
            else FilterPack(known_triples, model.num_entities)
        )
        if devices is None and device is not None:
            devices = [device]
        devs = replica_devices(home_slot, resolve_serve_replicas(replicas), devices)
        self.replicas = [Replica(i, d) for i, d in enumerate(devs)]
        #: dispatch-ahead depth: two batches per replica keeps every device
        #: busy while the host assembles the next batch
        self.max_inflight = (
            2 * len(self.replicas) if max_inflight is None else int(max_inflight)
        )
        plan = resolve_serve_faults(serve_faults)
        if isinstance(plan, str):
            plan = ServeFaultPlan.parse(plan)
        self.fault_plan: Optional[ServeFaultPlan] = plan
        self.fault_counts: Dict[str, int] = {}
        self.retry_limit = int(retry_limit)
        self.breaker_fails = int(breaker_fails)
        self.probe_after = int(probe_after)
        self.hedge_after = hedge_after
        self.max_queue = None if max_queue is None else int(max_queue)
        self.queue: Deque[QueryRequest] = deque()
        self.inflight: Deque[_InFlight] = deque()
        #: hedge/primary losers still executing: reaped only to release
        #: their replica's in-flight slot, outputs discarded
        self._zombies: List[_InFlight] = []
        self.stats: Dict[str, int] = {
            "submitted": 0, "served": 0, "failed": 0, "shed": 0,
            "rejected": 0, "retried": 0, "hedged": 0,
            "breaker_open": 0, "breaker_close": 0,
            "batches": 0, "published": 0, "publish_errors": 0,
            "padded_rows": 0, "warmed": 0, "relation_groups": 0,
        }
        #: bucket specs run once at publish: ("rank", rows) or
        #: ("topk", rows, k), rounded to the pow-2 buckets the loop pads to
        self.warm_buckets: List[Tuple] = list(warm_buckets or [])
        for spec in self.warm_buckets:
            if (not spec or spec[0] not in ("rank", "topk")
                    or len(spec) != (2 if spec[0] == "rank" else 3)):
                raise ValueError(
                    f"warm bucket {spec!r}: expected ('rank', rows) or "
                    f"('topk', rows, k)"
                )
        #: (kind, bucket_rows, k_bucket, replica_slot) signatures already run
        self._warmed: set = set()
        self._next_rid = 0
        #: monotone launch sequence number: the fault plan's draw clock and
        #: the breaker's probe clock
        self._seq = 0
        self._publish_lock = threading.Lock()
        self._active: Optional[TableVersion] = None
        #: whether rank batches carry their rows' relation groups
        self.grouped = by_relation_group(model)
        self.publish(params, version=0)
        self.stats["published"] = 0  # the constructor's own staging isn't a flip

    # ------------------------------------------------------------ publish
    @property
    def version(self) -> int:
        return self._active.version

    def publish(self, params, *, version: Optional[int] = None) -> TableVersion:
        """Publish a new table version and atomically make it active:
        build the ``TableVersion`` (one copy of the tables, one finiteness
        reduction per table), stage it onto every replica (zero-copy where
        the copy sits), run the warm buckets, then flip the active pointer."""
        with self._publish_lock:
            v = (
                (self._active.version + 1 if self._active is not None else 0)
                if version is None else int(version)
            )
            tv = TableVersion(params, self.model, self.filters,
                              version=v, owner=self.owner)
            for rep in self.replicas:
                tv.on(rep.device)
            self._warm(tv)
            self._active = tv
            self.stats["published"] += 1
            return tv

    def _bucket_rows(self, rows: int) -> int:
        return _pow2_at_least(rows, self.min_bucket if self.serve_impl == "batched" else 1)

    def _warm(self, tv: TableVersion) -> None:
        """Run each configured bucket once per replica with zero-id dummy
        queries, the first time its signature is seen, so the kernels are
        built and loaded before real traffic. Results are dropped — no
        stats, no in-flight accounting."""
        if not self.warm_buckets:
            return
        for rep in self.replicas:
            for spec in self.warm_buckets:
                kind = spec[0]
                rows = self._bucket_rows(spec[1])
                kb = (
                    min(_pow2_at_least(spec[2]), self.model.num_entities)
                    if kind == "topk" else 0
                )
                sig = (kind, rows, kb, rep.slot)
                if sig in self._warmed:
                    continue
                z = np.zeros(rows, dtype=np.int64)
                if kind == "rank":
                    filt = np.concatenate(
                        [z[:, None].astype(np.int32), self.filters.rows_for(z, z)], axis=1
                    )
                    host_in = (z, z, z, filt)
                    if self.grouped:
                        host_in = self._with_groups(host_in)
                else:
                    host_in = (z, z, self.filters.rows_for(z, z))
                out = self._run(kind, host_in, tv.on(rep.device), rep.device, kb)
                if rep.device.type == "cuda":
                    torch.cuda.synchronize(rep.device)
                del out
                self._warmed.add(sig)
                self.stats["warmed"] += 1

    def attach(self, sched, owner: str) -> "KGEServingTier":
        """Subscribe to a federation scheduler's accept hook (an object with
        ``trainers`` and ``add_accept_listener``): every accepted update for
        ``owner`` republishes. Publish failures are counted, never raised
        into the federation."""
        if owner not in sched.trainers:
            raise ValueError(f"unknown owner {owner!r}")
        self.owner = owner

        def _on_accept(name, tick, params):
            if name != owner:
                return
            try:
                self.publish(params)
            except Exception:
                self.stats["publish_errors"] += 1

        sched.add_accept_listener(_on_accept)
        self.publish(dict(sched.trainers[owner].params))
        return self

    @classmethod
    def for_owner(cls, sched, owner: str, **kw) -> "KGEServingTier":
        """A tier serving ``owner``'s tables out of a federation: filters
        from the owner's train ∪ valid ∪ test, tables from its trainer, the
        home slot from the scheduler's sticky owner placement (where the
        batched tick engine keeps the owner's tables), and the accept hook
        attached."""
        tr = sched.trainers[owner]
        kg = sched.kgs[owner]
        known = np.concatenate([kg.train, kg.valid, kg.test])
        engine = getattr(sched, "_tick_engine", None)
        if engine is not None and "home_slot" not in kw:
            kw["home_slot"] = engine.placement.slot(owner)
        tier = cls(tr.params, tr.model, known, owner=owner, **kw)
        tier.attach(sched, owner)
        return tier

    # ------------------------------------------------------------- submit
    def _admit(self) -> None:
        """Admission control, cheapest check first: a full queue rejects at
        submit, before any validation work is spent."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats["rejected"] += 1
            raise TierOverloadError(
                f"queue at max_queue={self.max_queue}; request rejected at submit"
            )

    def _submit(self, req: QueryRequest) -> QueryRequest:
        self.stats["submitted"] += 1
        self.queue.append(req)
        return req

    def submit_rank(self, h, r, t, *, deadline: Optional[float] = None) -> QueryRequest:
        """Queue a filtered-rank query batch; returns immediately."""
        self._admit()
        tv = self._active
        h = check_id_range("head entity", h, self.model.num_entities)
        t = check_id_range("tail entity", t, self.model.num_entities)
        r = check_id_range("relation", r, self.model.num_relations)
        tv.check_finite("entity", tv.ent_bad, h)
        tv.check_finite("relation", tv.rel_bad, r)
        rid = self._next_rid
        self._next_rid += 1
        return self._submit(QueryRequest(rid, "rank", h, r, t, deadline=deadline))

    def submit_topk(self, h, r, *, k: int = 10,
                    deadline: Optional[float] = None) -> QueryRequest:
        """Queue a top-k candidate query batch; returns immediately."""
        self._admit()
        tv = self._active
        h = check_id_range("head entity", h, self.model.num_entities)
        r = check_id_range("relation", r, self.model.num_relations)
        if not 1 <= k <= self.model.num_entities:
            raise ValueError(f"k must be in [1, {self.model.num_entities}], got {k}")
        tv.check_finite("entity", tv.ent_bad, h)
        tv.check_finite("relation", tv.rel_bad, r)
        rid = self._next_rid
        self._next_rid += 1
        return self._submit(QueryRequest(rid, "topk", h, r, k=int(k), deadline=deadline))

    # ------------------------------------------------------ admission loop
    def _shed(self, req: QueryRequest, now: float) -> None:
        """Terminal ``shed``: the deadline expired while queued; never
        dispatched (distinct from ``failed``)."""
        req.shed = True
        req.done = True
        req.finished_at = now
        self.stats["shed"] += 1

    @staticmethod
    def _expired(req: QueryRequest, now: float) -> bool:
        return req.deadline is not None and now - req.submitted_at > req.deadline

    def _coalesce(self) -> Tuple[List[QueryRequest], float]:
        """Pop the FIFO head's batchable prefix: same kind (and top-k
        bucket), up to ``max_batch`` rows; expired requests are shed as they
        surface. ``direct`` mode takes one request. Returns the requests and
        the time they left the queue."""
        now = time.perf_counter()
        while self.queue and self._expired(self.queue[0], now):
            self._shed(self.queue.popleft(), now)
        if not self.queue:
            return [], now
        head = self.queue[0]
        take = [self.queue.popleft()]
        if self.serve_impl == "direct":
            return take, now
        rows = len(head.h)
        kb = _pow2_at_least(head.k) if head.kind == "topk" else 0
        while self.queue and rows < self.max_batch:
            nxt = self.queue[0]
            if self._expired(nxt, now):
                self._shed(self.queue.popleft(), now)
                continue
            if nxt.kind != head.kind:
                break
            if head.kind == "topk" and _pow2_at_least(nxt.k) != kb:
                break
            if rows + len(nxt.h) > self.max_batch:
                break
            take.append(self.queue.popleft())
            rows += len(nxt.h)
        return take, now

    def _pad(self, arrs: List[np.ndarray], nq: int) -> List[np.ndarray]:
        """Pad the batch to its pow-2 bucket by repeating row 0; padded rows
        compute and are discarded."""
        nb = self._bucket_rows(nq)
        if nb == nq:
            return arrs
        self.stats["padded_rows"] += nb - nq
        return [
            np.concatenate([a, np.repeat(a[:1], nb - nq, axis=0)], axis=0)
            for a in arrs
        ]

    # ------------------------------------------------------------- routing
    def _eligible(self) -> List[Replica]:
        """Healthy replicas plus unhealthy ones whose probe is due; the
        whole ring when the breaker is open everywhere."""
        pool = [rp for rp in self.replicas if rp.healthy]
        pool += [
            rp for rp in self.replicas
            if not rp.healthy and rp.probe_at is not None
            and self._seq >= rp.probe_at
        ]
        return pool or list(self.replicas)

    def _pick_replica(self, exclude: Tuple[Replica, ...] = ()) -> Replica:
        """Least-loaded eligible replica, tie-broken by lifetime dispatch
        count before slot. ``exclude`` steers retries/hedges away from the
        replica that just failed (dropped if it would empty the pool)."""
        pool = [rp for rp in self._eligible() if rp not in exclude]
        if not pool:
            pool = [rp for rp in self.replicas if rp not in exclude]
        if not pool:
            pool = self._eligible()
        rp = min(pool, key=lambda rp: (rp.inflight, rp.dispatched, rp.slot))
        if not rp.healthy:
            # half-open: this pick IS the probe
            rp.probe_at = self._seq + self.probe_after
        return rp

    def _note_failure(self, rep: Replica) -> None:
        rep.fails += 1
        if rep.healthy and rep.fails >= self.breaker_fails:
            rep.healthy = False
            rep.probe_at = self._seq + self.probe_after
            self.stats["breaker_open"] += 1
        elif not rep.healthy:
            rep.probe_at = self._seq + self.probe_after

    def _note_success(self, rep: Replica, latency_s: float) -> None:
        rep.fails = 0
        if not rep.healthy:
            rep.healthy = True
            rep.probe_at = None
            self.stats["breaker_close"] += 1
        rep.ewma_s = (
            latency_s if rep.ewma_s is None else 0.8 * rep.ewma_s + 0.2 * latency_s
        )

    # ------------------------------------------------------------ dispatch
    def _revalidate(self, reqs: List[QueryRequest], tv: TableVersion
                    ) -> List[QueryRequest]:
        """Re-check finiteness against the version the batch is pinned to
        (a hot-swap may have landed since submit); requests touching bad
        rows fail here instead of serving garbage."""
        ok: List[QueryRequest] = []
        now: Optional[float] = None
        for q in reqs:
            bad = bool(tv.ent_bad[q.h].any()) or bool(tv.rel_bad[q.r].any())
            if not bad and q.kind == "rank":
                bad = bool(tv.ent_bad[q.t].any())
            if bad:
                if now is None:
                    now = time.perf_counter()
                q.error = ValueError(
                    f"non-finite query embedding in dispatch version "
                    f"{tv.version} (hot-swap between submit and dispatch)"
                )
                q.done = True
                q.finished_at = now
                self.stats["failed"] += 1
            else:
                ok.append(q)
        return ok

    def _dispatch(self, reqs: List[QueryRequest], coalesced_at: float,
                  assemble_at: Optional[float] = None) -> int:
        """Assemble and launch one batch; ``assemble_at`` (taken only while
        spans are recorded) starts its ``tier.assemble`` span."""
        tv = self._active  # ONE read: the batch is pinned to this version
        reqs = self._revalidate(reqs, tv)
        if not reqs:
            return 0
        kind = reqs[0].kind
        h = np.concatenate([q.h for q in reqs])
        r = np.concatenate([q.r for q in reqs])
        nq = len(h)
        segs, off = [], 0
        for q in reqs:
            segs.append((q, off, len(q.h)))
            off += len(q.h)
        grouped_at = None
        if kind == "rank":
            t = np.concatenate([q.t for q in reqs])
            filt = np.concatenate(
                [t[:, None].astype(np.int32), self.filters.rows_for(h, r)], axis=1,
            )
            host_in = tuple(self._pad([h, r, t, filt], nq))
            if self.grouped:
                g0 = time.perf_counter()
                host_in = self._with_groups(host_in)
                ngroups = int(np.count_nonzero(host_in[4][:-1] < len(host_in[0])))
                self.stats["relation_groups"] += ngroups
                grouped_at = (g0, time.perf_counter(), ngroups)
            kb = 0
        else:
            kb = min(_pow2_at_least(reqs[0].k), self.model.num_entities)
            filt = self.filters.rows_for(h, r)
            host_in = tuple(self._pad([h, r, filt], nq))
        self.stats["batches"] += 1
        if assemble_at is not None:
            sp = tracing.record("tier.assemble", assemble_at, time.perf_counter(),
                                seq=self._seq, rows=nq, requests=len(reqs))
            if grouped_at is not None:
                tracing.record("tier.group", grouped_at[0], grouped_at[1], parent=sp,
                               seq=self._seq, rows=len(host_in[0]), groups=grouped_at[2])
        self._launch(kind, host_in, segs, nq, tv, kb, coalesced_at=coalesced_at)
        return nq

    @staticmethod
    def _with_groups(host_in: Tuple) -> Tuple:
        """A padded rank batch ``(h, r, t, filt)`` with its rows' relation
        groups, sorted on the host: ``(h, r, t, order, offsets, filt)``."""
        h, r, t, filt = host_in
        return (h, r, t, *relation_groups_host(r), filt)

    def _run(self, kind: str, host_in: Tuple, ptab, device: torch.device,
             kb: int) -> Tuple:
        """Launch one padded batch on ``device``: the rank counts, or the
        (vals, ids) top-k pair. Asynchronous on a CUDA device. A rank batch
        is ``(h, r, t, filt)``, or ``(h, r, t, order, offsets, filt)`` where
        the family ranks by relation group."""
        dev_in = [torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)
                  for a in host_in]
        if kind == "rank":
            if self.grouped:
                dh, dr, dt, order, offsets, df = dev_in
                return (side_counts_dispatch(ptab, self.model, dh, dr, dt, df,
                                             side="tail", block_e=self.block_e,
                                             groups=(order, offsets)),)
            dh, dr, dt, df = dev_in
            return (side_counts_dispatch(ptab, self.model, dh, dr, dt, df,
                                         side="tail", block_e=self.block_e),)
        dh, dr, df = dev_in
        return topk_tails_dispatch(ptab, self.model, dh, dr, df, k=kb,
                                   block_e=self.block_e)

    def _launch(self, kind: str, host_in: Tuple, segs, nq: int,
                tv: TableVersion, kb: int, *, coalesced_at: float, attempts: int = 0,
                exclude: Tuple[Replica, ...] = (),
                hedge_of: Optional[_InFlight] = None) -> _InFlight:
        """One device dispatch of an assembled batch (primary, retry or
        hedge — each takes a fresh launch sequence number, so the fault
        plan draws independently per attempt)."""
        launch_at = time.perf_counter() if tracing.recording() else None
        rep = self._pick_replica(exclude=exclude)
        seq = self._seq
        self._seq += 1
        fault = None
        if self.fault_plan is not None:
            fault = self.fault_plan.draw(seq, rep.slot)
            if fault is not None:
                self.fault_counts[fault.kind] = self.fault_counts.get(fault.kind, 0) + 1
        out = self._run(kind, host_in, tv.on(rep.device), rep.device, kb)
        event = None
        if rep.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(rep.device))
        rep.inflight += 1
        rep.dispatched += 1
        fl = _InFlight(
            kind, out, segs, nq, tv, rep, host_in=host_in, kb=kb, seq=seq,
            attempts=attempts, fault=fault, coalesced_at=coalesced_at,
            dispatched_at=time.perf_counter(), event=event,
        )
        if launch_at is not None:
            tracing.record("tier.launch", launch_at, fl.dispatched_at, seq=seq, kind=kind,
                           rows=len(host_in[0]), filter_width=host_in[-1].shape[1],
                           replica=rep.slot)
        if hedge_of is None:
            self.inflight.append(fl)
        return fl

    def _maybe_hedge(self) -> None:
        """If the FIFO head has been in flight longer than ``hedge_after``
        seconds, launch a duplicate on a different replica; the first
        result wins (bit-identical: same pinned version)."""
        if self.hedge_after is None or not self.inflight:
            return
        b = self.inflight[0]
        if b.hedge is not None or b.ready():
            return
        if time.perf_counter() - b.dispatched_at < self.hedge_after:
            return
        if all(rp is b.replica for rp in self.replicas):
            return  # no second replica to hedge onto
        b.hedge = self._launch(
            b.kind, b.host_in, b.segs, b.nq, b.tv, b.kb, coalesced_at=b.coalesced_at,
            attempts=b.attempts, exclude=(b.replica,), hedge_of=b,
        )
        self.stats["hedged"] += 1

    # ------------------------------------------------------------- collect
    def _output_bad(self, kind: str, host: List[np.ndarray]) -> bool:
        """Armed-only output screen: rank counts finite and non-negative;
        top-k scores finite or -inf (a filtered slot)."""
        if kind == "rank":
            c = host[0]
            if c.dtype.kind == "f" and not np.isfinite(c).all():
                return True
            return bool((c < 0).any())
        vals = host[0]
        return not bool(np.all(np.isfinite(vals) | np.isneginf(vals)))

    def _poison(self, kind: str, host: List[np.ndarray], fault: ServeFault
                ) -> List[np.ndarray]:
        """Apply an injected ``poison``: rank counts go negative, top-k
        scores go NaN — damage the armed screen must catch."""
        host = [np.array(x, copy=True) for x in host]
        n = min(max(1, fault.rows), host[0].shape[0])
        if kind == "rank":
            host[0][:n] = -(10 ** 6)
        else:
            host[0][:n] = np.nan
        return host

    def _collect(self, src: _InFlight, kind: str) -> List[np.ndarray]:
        """One launch's outputs on the host, surfacing injected crashes,
        applying injected poison and screening when the fault layer is
        armed. Raises on anything unservable."""
        if src.fault is not None and src.fault.kind == "crash":
            raise ServeFaultError("crash", src.seq, src.replica.slot)
        with tracing.span("tier.copy"):
            host = [x.cpu().numpy() for x in src.out]
        if src.fault is not None and src.fault.kind == "poison":
            host = self._poison(kind, host, src.fault)
        if self.fault_plan is not None and self._output_bad(kind, host):
            raise ServeFaultError("poison", src.seq, src.replica.slot)
        return host

    def _finish_batch(self, b: _InFlight) -> None:
        """Resolve one batch: take the first usable result (primary or
        hedge), zombie the loser, and on total failure re-dispatch to a
        different replica or, past ``retry_limit``, fail its requests."""
        sources = (
            [b] if b.hedge is None
            else ([b, b.hedge] if b.ready() else [b.hedge, b])
        )
        host = None
        used = None
        err: Optional[Exception] = None
        spent: List[_InFlight] = []
        for src in sources:
            try:
                host = self._collect(src, b.kind)
                used = src
                break
            except Exception as ex:  # device-side failure: isolate to batch
                err = ex
                src.replica.inflight -= 1
                self._note_failure(src.replica)
                spent.append(src)
        if host is None:
            failed = tuple(s.replica for s in spent)
            if b.attempts < self.retry_limit:
                self.stats["retried"] += 1
                self._launch(b.kind, b.host_in, b.segs, b.nq, b.tv, b.kb,
                             coalesced_at=b.coalesced_at, attempts=b.attempts + 1,
                             exclude=failed)
                return
            now = time.perf_counter()
            for q, _, _ in b.segs:
                q.error, q.done, q.finished_at = err, True, now
            self.stats["failed"] += len(b.segs)
            return
        now = time.perf_counter()
        used.replica.inflight -= 1
        self._note_success(used.replica, now - used.dispatched_at)
        for src in sources:
            if src is not used and src not in spent:
                self._zombies.append(src)
        for q, off, n in b.segs:
            if b.kind == "rank":
                q.result = host[0][off:off + n] + 1
            else:
                vals, ids = host
                q.result = (ids[off:off + n, :q.k], vals[off:off + n, :q.k])
            q.version = b.tv.version
            q.finished_at = now
            q.done = True
        self.stats["served"] += len(b.segs)

    def _reap_zombies(self) -> None:
        if not self._zombies:
            return
        keep = []
        for z in self._zombies:
            # device readiness only: a zombie's simulated straggle is moot
            if z.device_ready():
                z.replica.inflight -= 1
            else:
                keep.append(z)
        self._zombies = keep

    def _batch_ready(self, b: _InFlight) -> bool:
        return b.ready() or (b.hedge is not None and b.hedge.ready())

    def _finish_traced(self, b: _InFlight) -> None:
        """``_finish_batch`` in a ``tier.collect`` span, then a
        ``tier.request`` span for each request it served, its phases cut at
        its own stamps and at the collect's start."""
        with tracing.span("tier.collect", seq=b.seq, kind=b.kind) as sp:
            self._finish_batch(b)
        collect_at = sp.start
        for q, _, _ in b.segs:
            if q.state != "served":
                continue
            tracing.record(
                "tier.request", q.submitted_at, q.finished_at, rid=q.rid, seq=b.seq,
                queue_ms=1e3 * (b.coalesced_at - q.submitted_at),
                host_ms=1e3 * (b.dispatched_at - b.coalesced_at),
                inflight_ms=1e3 * (collect_at - b.dispatched_at),
                collect_ms=1e3 * (q.finished_at - collect_at))

    def _reap(self, *, block: bool = False) -> int:
        """Collect completed batches; with ``block`` wait for the oldest
        (polling, so simulated straggles are honored and hedging keeps
        firing), then drain whatever else already finished."""
        done = 0
        self._reap_zombies()
        while self.inflight:
            head = self.inflight[0]
            if not self._batch_ready(head):
                if not block:
                    break
                self._maybe_hedge()
                time.sleep(2e-4)
                continue
            block = False
            b = self.inflight.popleft()
            if tracing.recording():
                self._finish_traced(b)
            else:
                self._finish_batch(b)
            self._reap_zombies()
            done += len(b.segs)
        return done

    # -------------------------------------------------------- driving loop
    def step(self) -> int:
        """One admission-loop tick: collect finished batches, hedge the
        oldest stuck one, then dispatch at most one coalesced batch.
        Returns the query rows dispatched."""
        self._reap()
        self._maybe_hedge()
        if not self.queue:
            return 0
        while len(self.inflight) >= self.max_inflight:
            self._reap(block=True)
        assemble_at = time.perf_counter() if tracing.recording() else None
        reqs, coalesced_at = self._coalesce()
        if not reqs:
            return 0
        return self._dispatch(reqs, coalesced_at, assemble_at)

    def run_until_drained(self, *, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.queue and not self.inflight:
                if self._zombies:
                    self._reap_zombies()
                    if self._zombies:
                        time.sleep(2e-4)
                    continue
                self._check_accounting()
                return
            if self.queue:
                self.step()
            else:
                self._reap(block=True)
        raise RuntimeError("serving tier failed to drain")

    def _check_accounting(self) -> None:
        """Every submitted request ended in exactly one of served/shed/failed
        (rejected requests never entered)."""
        s = self.stats
        if s["served"] + s["shed"] + s["failed"] != s["submitted"]:
            raise RuntimeError(
                f"serving accounting broken: served={s['served']} + "
                f"shed={s['shed']} + failed={s['failed']} != "
                f"submitted={s['submitted']}"
            )

    # ------------------------------------------------------- observability
    def replica_load(self) -> List[Tuple[int, int]]:
        """[(slot, lifetime batches)] — the routing spread."""
        return [(rp.slot, rp.dispatched) for rp in self.replicas]

    def health(self) -> List[Dict]:
        """Per-replica health: breaker state, consecutive failures,
        smoothed latency and routing counters."""
        return [
            {
                "slot": rp.slot, "healthy": rp.healthy, "fails": rp.fails,
                "inflight": rp.inflight, "dispatched": rp.dispatched,
                "ewma_ms": None if rp.ewma_s is None else rp.ewma_s * 1e3,
                "probe_at": rp.probe_at,
            }
            for rp in self.replicas
        ]
