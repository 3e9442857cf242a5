"""Federated training orchestrator — §3.3, Alg. 1, Fig. 2.

The handshake protocol as a host-side scheduler, as in the JAX package's
``core/federation.py``:

  * states Ready / Busy / Sleep (and Quarantined) per KG owner;
  * a handshake queue per owner: client KGs offering to federate (their
    generator against our discriminators);
  * KGEmb-Update: PPAT → aggregate the synthesized embeddings (+ virtual
    entities) → local retrain → score;
  * Backtrack: keep the new embeddings only if the score improved, else
    restore the snapshot (Alg. 1 l. 17);
  * Broadcast: on improvement, offer a handshake to every partner with
    shared aligned entities (Alg. 1 l. 30).

The paper's asynchrony is modelled as scheduler ticks. Each tick is planned
at its start: every Ready owner contributes one entry — a handshake with the
front of its offer queue, or a self-train — and each handshake's client
tables are frozen then, so accepts made during a tick take effect from the
next one. Two engines run a plan (``tick_impl=``, ``REPRO_TICK_IMPL``):
``batched`` (the default, as in the JAX package; ``core.tick_engine``) runs
every entry as one program per entry signature — captured CUDA graphs on a
card — with one host sync per tick, over the owners' home devices when
``tick_placement="sharded"``; ``reference`` is the serial per-owner loop
(``_run_serial``). Both take the same decisions and give the same tables
from the same draws; ``batched`` needs a training step other than the dense
``reference`` loop.

Two scheduling disciplines (``tick_sync=``, ``REPRO_TICK_SYNC``):
``barrier`` (the default) runs lockstep ticks. ``stream`` (``_run_stream``)
cuts each pass's plan into dependency levels (entries sharing a host or
client serialize in plan order; disjoint ones stream), so an update accepted
at one level can serve a later level of the same pass. Client views carry
the client's published version; a view more than ``staleness_bound``
versions stale at its level's dispatch is not used: the entry emits a
``fault="stale"`` audit event and re-offers against a re-frozen view in a
trailing level (once per pass; after that the offer goes back to the front
of the queue). A streamed pass whose gate never fires takes the barrier's
decisions.

Frozen client views are copies (``trainer.snapshot()``), not the live
tables: the port's training steps and ``set_entity_embeddings`` write tables
in place, so a view sharing storage with its owner would see that owner's
own handshake earlier in the same tick.

The fault-tolerance layer (``tick_faults=``, ``REPRO_TICK_FAULTS``) injects
seeded crashes, stragglers, lost messages and corrupt embeddings
(``core.faults``); one failing entry never aborts its tick — its host is
restored, the handshake re-queued with exponential backoff, and repeated
blame quarantines a peer for ``quarantine_ticks`` ticks.

The adversary (``tick_adversary=``, ``REPRO_TICK_ADVERSARY``;
``core.adversary``) tampers a handshake's frozen client view with seeded,
norm-evading drift, sybil or replay attacks. The Byzantine defenses, off by
default, answer it: ``robust_agg`` clamps the synthesized aligned rows
toward the honest majority's deltas (``aggregation.robust_rows``),
``cos_screen`` rejects a handshake whose synthesized rows point away from
the host's own as ``fault="poison"`` (blaming the client, with a threshold
that sharpens as the client's reputation decays), and with either armed the
offer queue serves the best-reputed client first. Per entry the order is
fixed: frozen view → adversary tamper → fault corruption → receiver screen,
all before any PPAT draw. ``checkpoint.save_scheduler`` /
``restore_scheduler`` cut and resume a run between ticks.

Randomness is a seam. By default the PPAT rounds draw from a
``torch.Generator`` seeded ``seed + 101`` on the scheduler's device and each
trainer from its own engine generator. ``draws=`` takes a source with two
methods instead, called where the JAX package splits its keys:
``ppat(host, client, n_x, n_y) -> (init, PPATDraws)`` once per handshake
that gets past the fault checks, and ``train(owner, epochs, n_pad, nb,
batch, num_entities) -> [per-epoch draws]`` for every ``train_epochs``; a
source that is to be checkpointed also has ``state_dict`` and
``load_state_dict``. In a barrier tick a handshake draws its PPAT inputs
when it runs. A streamed pass draws them in plan order when the pass is
planned (``_assign_entry_draws``), skipping entries whose fault kills them
before any draw (crash, drop, corrupt), and for a re-offer level when the
level is made, as the JAX package splits its PPAT keys; a level then runs
with the inputs its entries carry. So the PPAT draws come in the barrier's
order whatever order the levels run in; the training draws still come as
each level trains.
"""
from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.adversary import Adversary, resolve_adversary
from repro_torch.core.aggregation import (
    ROBUST_AGG_MODES,
    kgemb_update,
    robust_rows,
    virtual_extension,
)
from repro_torch.core.alignment import AlignmentRegistry, procrustes
from repro_torch.core.distributed import committed_device
from repro_torch.core.faults import FaultError, FaultInjector, FaultPlan, screen_rows
from repro_torch.core.ppat import (
    PPAT_BUCKET,
    PPATConfig,
    _init_host_params,
    _pad_rows,
    draw_ppat,
    train_ppat,
)
from repro_torch.core.privacy import MomentsAccountant
from repro_torch.core.tick_engine import TickEngine
from repro_torch.kernels.dispatch import (
    resolve_device,
    resolve_tick_adversary,
    resolve_tick_faults,
    resolve_tick_impl,
    resolve_tick_placement,
    resolve_tick_residency,
    resolve_tick_sync,
    resolve_train_impl,
)
from repro_torch.kge.data import corrupt_triples
from repro_torch.kge.engine import as_device, draw_epoch
from repro_torch.kge.eval import best_threshold_accuracy, build_score_inputs, link_prediction
from repro_torch.kge.models import score_triples
from repro_torch.kge.trainer import KGETrainer
from repro_torch.utils import tracing


class NodeState(enum.Enum):
    READY = "ready"
    BUSY = "busy"
    SLEEP = "sleep"
    #: expelled after repeated attributed failures; released back to READY
    #: after ``quarantine_ticks`` ticks. Plans no entries; offers from it
    #: are deferred, not dropped.
    QUARANTINED = "quarantined"


@dataclass
class FederationEvent:
    """One protocol action. ``seconds`` measures executed work (the device
    is synchronised before the clock is read). Under the serial engine it is
    the entry's own time; under the batched engine the entries of a tick run
    together, and every entry is given the whole batched tick's time (plus
    its injected straggle). An entry's own time under batching is the
    ``stream_ms`` of its ``tick.entry`` span, recorded while a profiler
    session is active (``utils.tracing``): the time its segments took on its
    stream, which counts the host's launch stalls inside them and waits
    behind the other entries' streams besides its device time."""

    tick: int
    host: str
    client: Optional[str]
    kind: str  # "ppat" | "self-train" | "init"
    score_before: float
    score_after: float
    accepted: bool
    epsilon: float = float("nan")
    seconds: float = 0.0
    #: non-None when this entry failed: "crash" | "straggle" | "drop" |
    #: "corrupt" | "poison" (the cosine-shift screen rejected the exchange) |
    #: "stale" (a streamed entry's view was past the staleness bound)
    fault: Optional[str] = None
    #: the adversary's attack on this entry's client view ("drift" |
    #: "sybil" | "replay"), if one was drawn
    attack: Optional[str] = None
    #: dependency level (0 for every barrier-mode entry; a streamed pass
    #: numbers its levels from 0)
    level: int = 0
    #: the host's per-owner logical clock after this entry: how many entries
    #: (init, handshake, self-train) it has hosted
    owner_clock: int = 0
    #: handshakes: the client's published version when its view was frozen;
    #: init/self-train: the host's own published version at stamp time
    view_version: int = 0
    #: simulated completion time (reporting only)
    sim_finish: float = 0.0


@dataclass
class TickEntry:
    """One planned unit of tick work; ``client_view`` is a copy of the
    client's tables taken at plan time."""

    host: str
    kind: str  # "ppat" | "self-train"
    client: Optional[str] = None
    client_view: Optional[Dict[str, torch.Tensor]] = None
    #: the client's published-version counter at view-freeze time
    view_version: int = 0
    #: simulated publish time of the frozen view (streamed reporting only)
    sim_wait: float = 0.0
    #: a streamed handshake's PPAT inputs ``(init, PPATDraws)``, drawn in
    #: plan order when its pass was planned; ``None`` draws when it runs
    ppat_draws: Optional[tuple] = None


class _ClientView:
    """Read-only embedding access over a frozen client view, with the
    trainer surface ``virtual_extension`` expects. Gathered rows are shipped
    to ``device`` (the host's), the client → host message of the protocol.
    ``screen`` (a row-norm bound, set while a fault injector is active)
    makes every gather a receiver-side integrity check that raises
    ``CorruptEmbeddingError``."""

    def __init__(self, params: Dict[str, torch.Tensor], device=None, *,
                 screen: Optional[float] = None, host: str = "",
                 client: Optional[str] = None):
        self.params = params
        self.device = device
        self.screen = screen
        self._who = (host, client)

    def _ship(self, rows: torch.Tensor) -> torch.Tensor:
        if self.screen is not None:
            screen_rows(rows, bound=self.screen, host=self._who[0],
                        client=self._who[1], what="client embeddings")
        return rows if self.device is None else rows.to(self.device)

    def _gather(self, key: str, idx) -> torch.Tensor:
        table = self.params[key]
        return self._ship(table[as_device(np.asarray(idx, np.int64), table.device)])

    def get_entity_embeddings(self, idx) -> torch.Tensor:
        return self._gather("ent", idx)

    def get_relation_embeddings(self, idx) -> torch.Tensor:
        return self._gather("rel", idx)


class GeneratorDraws:
    """A draw source (``FederationScheduler(draws=...)``) from one seeded CPU
    ``torch.Generator``: the same draws whatever device the scheduler runs
    on, so that a run on the card can be held against a run on the CPU.
    Two sources with the same arguments give the same draws to schedulers
    that ask in the same order."""

    def __init__(self, seed: int, cfg: PPATConfig, dim: int):
        self.cfg, self.dim = cfg, dim
        self._gen = torch.Generator().manual_seed(seed)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The generator's state, for ``checkpoint.save_scheduler``."""
        return {"gen": self._gen.get_state()}

    def load_state_dict(self, state: Dict) -> None:
        self._gen.set_state(torch.as_tensor(np.asarray(state["gen"]), dtype=torch.uint8))

    def ppat(self, host: str, client: str, n_x: int, n_y: int):
        return (_init_host_params(self._gen, self.dim, self.cfg),
                draw_ppat(self._gen, self.cfg, n_x, n_y))

    def train(self, owner: str, epochs: int, n_pad: int, nb: int, batch: int,
              num_entities: int):
        return [draw_epoch(self._gen, n_pad, nb, batch, num_entities) for _ in range(epochs)]


class FederationScheduler:
    """Alg. 1 over the owners ``kgs``, every table on ``device`` (the current
    CUDA card by default; ``"cpu"`` for the CPU)."""

    def __init__(
        self,
        kgs: Dict[str, object],
        *,
        families: Optional[Dict[str, str]] = None,
        dim: int = 64,
        registry: Optional[AlignmentRegistry] = None,
        ppat_cfg: Optional[PPATConfig] = None,
        aggregation: str = "average",
        procrustes_refine: bool = True,
        use_virtual: bool = True,
        local_epochs: int = 50,
        update_epochs: int = 25,
        score_fn: Optional[Callable] = None,
        score_split: str = "valid",
        score_metric: str = "accuracy",
        score_max_test: int = 200,
        seed: int = 0,
        margin: float = 2.0,
        batch_size: int = 100,
        tick_impl: Optional[str] = None,
        tick_placement: Optional[str] = None,
        tick_residency: Optional[str] = None,
        tick_faults=None,
        tick_adversary=None,
        robust_agg: str = "none",
        cos_screen: Optional[float] = None,
        rep_decay: float = 0.5,
        rep_recover: float = 0.25,
        retry_budget: int = 3,
        backoff_ticks: int = 1,
        quarantine_ticks: int = 4,
        tick_deadline: Optional[float] = None,
        tick_sync: Optional[str] = None,
        staleness_bound: int = 0,
        device=None,
        draws=None,
    ):
        # score_split="test" reproduces Alg. 1 verbatim (the paper backtracks
        # on g_j.test); "valid" (default) is the leakage-free variant.
        # score_metric="hit10" backtracks on filtered Hit@10 through the
        # fused-rank kernel instead of classification accuracy.
        if robust_agg not in ROBUST_AGG_MODES:
            raise ValueError(f"unknown robust_agg mode {robust_agg!r} "
                             f"(one of {'|'.join(ROBUST_AGG_MODES)})")
        if cos_screen is not None and not -1.0 <= cos_screen <= 1.0:
            raise ValueError(f"cos_screen={cos_screen} outside [-1, 1]")
        if staleness_bound < 0:
            raise ValueError(f"staleness_bound={staleness_bound} must be >= 0")
        if aggregation not in ("average", "replace"):
            raise ValueError(f"unknown aggregation mode {aggregation!r}")
        resolve_tick_impl(tick_impl)
        resolve_tick_sync(tick_sync)
        resolve_tick_placement(tick_placement)
        resolve_tick_residency(tick_residency)
        #: the owners' home: every table starts here (one card, or the CPU)
        self.device = resolve_device(device)
        self.score_split = score_split
        self.score_metric = score_metric
        self.score_max_test = score_max_test
        self.tick_impl = tick_impl
        self.tick_placement = tick_placement
        self.tick_residency = tick_residency
        #: a ``REPRO_TICK_ADVERSARY``-style spec, an ``AdversaryPlan`` or an
        #: ``Adversary``; resolved per ``run()``
        self.tick_adversary = tick_adversary
        #: robust aggregation over the synthesized aligned rows before KGEmb
        self.robust_agg = robust_agg
        #: cosine-shift accept gate (None = off), sharpened by ``_cos_tau``
        self.cos_screen = cos_screen
        self.tick_sync = tick_sync
        #: streamed mode's bounded-staleness rule, in published versions: a
        #: frozen view whose client published more than this many versions
        #: since the freeze re-offers instead
        self.staleness_bound = staleness_bound
        #: a ``REPRO_TICK_FAULTS``-style spec, a ``FaultPlan`` or a
        #: ``FaultInjector``; resolved per ``run()``
        self.tick_faults = tick_faults
        self.rep_decay = rep_decay      # reputation *= decay on blame
        self.rep_recover = rep_recover  # reputation += recover on accept
        self.retry_budget = retry_budget          # attributed failures → quarantine
        self.backoff_ticks = backoff_ticks        # base of the exponential backoff
        self.quarantine_ticks = quarantine_ticks  # timed release horizon
        self.tick_deadline = tick_deadline        # per-entry straggler deadline (s)
        self.kgs = kgs
        self.registry = registry or AlignmentRegistry.from_kgs(kgs)
        families = families or {n: "transe" for n in kgs}
        self.trainers: Dict[str, KGETrainer] = {
            n: KGETrainer(kg, families[n], dim=dim, seed=seed + i, margin=margin,
                          batch_size=batch_size, device=self.device)
            for i, (n, kg) in enumerate(kgs.items())
        }
        self.ppat_cfg = ppat_cfg or PPATConfig(seed=seed)
        self.aggregation = aggregation
        self.procrustes_refine = procrustes_refine
        self.use_virtual = use_virtual
        self.local_epochs = local_epochs
        self.update_epochs = update_epochs
        default_score = (
            self._valid_hit10 if score_metric == "hit10" else self._valid_accuracy
        )
        self.score_fn = score_fn or default_score
        self.state: Dict[str, NodeState] = {n: NodeState.READY for n in kgs}
        self.queue: Dict[str, deque] = {n: deque() for n in kgs}
        # membership mirror of each queue: broadcast() dedupes in O(1)
        self._queued: Dict[str, set] = {n: set() for n in kgs}
        self.best_score: Dict[str, float] = {}
        self.best_snapshot: Dict[str, dict] = {}
        #: ``fn(owner, tick, params)`` called on every accepted update — the
        #: serving tier's version-publish hook
        self._accept_listeners: List[Callable] = []
        self.events: List[FederationEvent] = []
        self.epsilons: List[float] = []
        #: federation-lifetime privacy spend: every handshake's moments merged
        self.accountant = MomentsAccountant(self.ppat_cfg.lam, self.ppat_cfg.delta)
        # ---- failure ledger (all empty while no fault fires) -------------
        #: consecutive failures per handshake pair (host, client): the
        #: exponent of that pair's backoff
        self._retries: Dict[tuple, int] = {}
        #: consecutive failures blamed on a peer; at ``retry_budget`` it is
        #: quarantined
        self._peer_failures: Dict[str, int] = {}
        #: deferred offers (release_tick, host, client), re-queued by plan_tick
        self._deferred: List[tuple] = []
        #: quarantined peer → release tick
        self._quarantine_until: Dict[str, int] = {}
        #: reputation per peer (absent = 1.0): decays on blame, recovers on
        #: accept. Only the armed defenses read it (``_defended``).
        self._reputation: Dict[str, float] = {}
        self._injector = None
        self._injector_src = None
        #: the resolved ``Adversary``, cached across runs: it carries the
        #: replay cache (``checkpoint.restore_scheduler`` refills it)
        self._adversary: Optional[Adversary] = None
        self._adversary_src = None
        self._tick = 0
        self._owner_clock: Dict[str, int] = {}
        #: per-owner published-version counter, bumped on every accept
        self._view_version: Dict[str, int] = {}
        #: simulated time at which each owner is next free, and at which its
        #: latest accepted version was published (reporting only)
        self._owner_free: Dict[str, float] = {}
        self._publish_sim: Dict[str, float] = {}
        self._draws = draws
        self._ppat_gen = torch.Generator(device=self.device).manual_seed(seed + 101)
        # scoring inputs come from the immutable splits: cached per owner,
        # keyed on what they depend on (see ``_score_universe``)
        self._acc_inputs: Dict[str, tuple] = {}
        self._lp_inputs: Dict[str, tuple] = {}
        #: the batched engine; its pair cache also serves the serial screens
        self._tick_engine = TickEngine(self)

    # ------------------------------------------------------------ scoring
    def _score_universe(self, name: str) -> tuple:
        """Version key of an owner's accuracy inputs: the scoring config and
        the current table extents (negatives are drawn against them)."""
        m = self.trainers[name].model
        return (self.score_split, self.score_max_test, m.num_entities, m.num_relations)

    def _accuracy_inputs(self, name: str) -> tuple:
        """(valid, fixed 1:1 negatives) for the accuracy backtrack metric,
        built once per owner per scoring-universe version."""
        version = self._score_universe(name)
        cached = self._acc_inputs.get(name)
        if cached is None or cached[0] != version:
            kg = self.kgs[name]
            rng = np.random.default_rng(0)  # fixed negatives → comparable
            va = kg.test if self.score_split == "test" else kg.valid
            neg = corrupt_triples(rng, va, self.trainers[name].model.num_entities)
            cached = (version, (va, neg))
            self._acc_inputs[name] = cached
        return cached[1]

    def _hit10_inputs(self, name: str) -> tuple:
        """(test, filt_t, filt_h) for the Hit@10 backtrack metric, built once
        per owner per scoring config (they do not depend on table extents)."""
        version = (self.score_split, self.score_max_test)
        cached = self._lp_inputs.get(name)
        if cached is None or cached[0] != version:
            split = "test" if self.score_split == "test" else "valid"
            cached = (version, build_score_inputs(self.kgs[name], split=split,
                                                  max_test=self.score_max_test))
            self._lp_inputs[name] = cached
        return cached[1]

    def _valid_accuracy(self, name: str) -> float:
        tr = self.trainers[name]
        va, va_neg = self._accuracy_inputs(name)
        dev = tr.params["ent"].device

        def s(t):
            t = as_device(np.asarray(t, np.int64), dev)
            return score_triples(tr.params, tr.model, t[:, 0], t[:, 1], t[:, 2]).cpu().numpy()

        _, acc = best_threshold_accuracy(s(va), s(va_neg), max_candidates=256)
        return acc

    def _valid_hit10(self, name: str) -> float:
        """Filtered Hit@10 on the score split, ranked by the fused-rank
        kernel (its plain version on the CPU)."""
        tr = self.trainers[name]
        split = "test" if self.score_split == "test" else "valid"
        lp = link_prediction(tr.params, tr.model, self.kgs[name], split=split,
                             max_test=self.score_max_test,
                             precomputed=self._hit10_inputs(name))
        return lp["hit@10"]

    # ------------------------------------------------------------ training
    def _train(self, name: str, epochs: int) -> float:
        """``train_epochs`` on one owner, with its draws from the draw source
        when there is one."""
        tr = self.trainers[name]
        if self._draws is None:
            return tr.train_epochs(epochs)
        n = len(tr._train_triples())
        b = min(tr.batch_size, n)
        nb = 1 << (max(1, -(-n // b)) - 1).bit_length()  # ``pad_triples``' batches
        return tr.train_epochs(epochs, draws=self._draws.train(
            name, epochs, nb * b, nb, b, tr.model.num_entities))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------ initial train
    def initial_training(self, epochs: Optional[int] = None) -> Dict[str, float]:
        """Alg. 1 ll. 2–4: local training to the best initial score."""
        epochs = epochs or self.local_epochs
        for name, tr in self.trainers.items():
            self._train(name, epochs)
            score = self.score_fn(name)
            self.best_score[name] = score
            self.best_snapshot[name] = tr.snapshot()
            ev = FederationEvent(self._tick, name, None, "init", 0.0, score, True)
            self.events.append(ev)
            self._notify_accept(name)
            self._stamp_events([None], [ev], level=0)
        # everyone announces itself once training is done (Fig. 2, round 1)
        for name in self.trainers:
            self.broadcast(name)
        return dict(self.best_score)

    # --------------------------------------------------------- primitives
    def add_accept_listener(self, fn: Callable) -> None:
        """Subscribe ``fn(owner, tick, params)`` to accepted updates. It runs
        synchronously at the accept site and must catch its own exceptions
        (the serving tier's listener counts them)."""
        self._accept_listeners.append(fn)

    def _notify_accept(self, owner: str) -> None:
        version = self._view_version.get(owner, 0) + 1
        self._view_version[owner] = version
        self._tick_engine.placement.note_version(owner, version)
        params = self.trainers[owner].params
        for fn in self._accept_listeners:
            fn(owner, self._tick, params)

    def broadcast(self, name: str) -> None:
        """Send a handshake signal to all partners with aligned entities."""
        for partner in self.registry.partners(name):
            if name not in self._queued[partner]:
                self.queue[partner].append(name)
                self._queued[partner].add(name)
            if self.state[partner] is NodeState.SLEEP:
                self.state[partner] = NodeState.READY  # wake-up signal

    def _pop_offer(self, name: str) -> str:
        client = self.queue[name].popleft()
        self._queued[name].discard(client)
        return client

    def federate_once(
        self,
        host: str,
        client: str,
        *,
        client_view: Optional[Dict[str, torch.Tensor]] = None,
        fault=None,
        attack=None,
        screen: Optional[float] = None,
        deadline: Optional[float] = None,
        ppat_draws: Optional[tuple] = None,
    ) -> FederationEvent:
        """ActiveHandshake + KGEmb-Update + Backtrack for one (client, host).

        ``client_view`` is the client's tables frozen at plan time (default:
        its live tables). ``fault`` is this entry's injected fault:
        ``crash``/``drop`` raise ``FaultError`` before any PPAT draw, and a
        ``straggle`` adds its simulated delay to the measured time.
        ``attack`` is the adversary's attack, already applied to
        ``client_view``; the event records its kind. ``screen`` arms the
        corrupt-row screen on client gathers; ``deadline`` turns an entry
        slower than it into a straggler whose result is discarded through
        the backtrack restore. ``ppat_draws`` gives the PPAT inputs drawn
        earlier (a streamed pass draws them in plan order); by default they
        are drawn here. The Byzantine defenses run whether or not an attack
        fired: honest exchanges must survive them."""
        t0 = time.perf_counter()
        if self.state[host] is not NodeState.QUARANTINED:
            # a host quarantined mid-tick (blamed as an earlier entry's
            # client) still runs its planned entry and stays quarantined
            self.state[host] = NodeState.BUSY
        if fault is not None and fault.kind in ("crash", "drop"):
            raise FaultError(fault.kind, host, client)
        idx_c, idx_h = self.registry.entities(client, host)
        rel = self.registry.relations(client, host)
        hos_tr = self.trainers[host]
        cli = _ClientView(
            client_view if client_view is not None else self.trainers[client].params,
            device=committed_device(hos_tr.params),
            screen=screen, host=host, client=client,
        )
        x = cli.get_entity_embeddings(idx_c)
        y = hos_tr.get_entity_embeddings(idx_h)
        if rel is not None and len(rel[0]):
            x = torch.cat([x, cli.get_relation_embeddings(rel[0])])
            y = torch.cat([y, hos_tr.get_relation_embeddings(rel[1])])

        if ppat_draws is None:
            ppat_draws = self._draw_ppat(host, client)
        init, draws = ppat_draws
        init = {k: {n: as_device(v, x.device) for n, v in p.items()} for k, p in init.items()}
        # init and draws given: train_ppat draws nothing from the generator
        ppat_client, ppat_host, hist = train_ppat(
            x, y, self.ppat_cfg, generator=self._ppat_gen, init=init, draws=draws)
        self.epsilons.append(hist["epsilon"])
        self.accountant.merge(ppat_host.accountant)  # federation-lifetime ε

        # generate and refine on the PPAT_BUCKET-padded aligned set, as the
        # JAX package does: zero rows map to zero rows and add nothing to
        # the procrustes product
        n_true = x.shape[0]
        synth = ppat_client.generate(_pad_rows(x, PPAT_BUCKET))
        refine = None
        if self.procrustes_refine:
            # host-local post-processing of the DP release with host-private
            # Y: the (ε, δ) guarantee is unchanged
            refine = procrustes(synth, _pad_rows(y, PPAT_BUCKET))
            synth = synth @ refine
        n_ent = len(idx_c)
        # robust acceptance over the entity rows on the padded shapes
        # (relation rows and padding pass through); skipped entirely while
        # the defenses are off
        mean_cos: Optional[float] = None
        if self._defended:
            synth, mc = robust_rows(_pad_rows(y, PPAT_BUCKET), synth, n_ent,
                                    mode=self.robust_agg, want_cos=self.cos_screen is not None)
            if self.cos_screen is not None:
                mean_cos = float(mc)
        kgemb_update(hos_tr, idx_h, synth[:n_ent], mode=self.aggregation)
        if rel is not None and len(rel[0]):
            cur = hos_tr.get_relation_embeddings(rel[1])
            new = synth[n_ent:n_true]
            if self.aggregation == "average":
                new = 0.5 * (cur + new)
            hos_tr.set_relation_embeddings(rel[1], new)

        ve = None
        if self.use_virtual:
            gen = (ppat_client.generate if refine is None
                   else (lambda e: ppat_client.generate(e) @ refine))
            ve = virtual_extension(hos_tr, cli, self.kgs[client], idx_c, idx_h, gen)
        self._train(host, self.update_epochs)  # KGEmb-Update retrain
        if ve is not None:
            hos_tr.strip_virtual()

        before = self.best_score[host]
        after = self.score_fn(host)
        self._sync()  # time executed work, not the enqueue
        elapsed = time.perf_counter() - t0
        if fault is not None and fault.kind == "straggle":
            elapsed += fault.delay
        straggled = deadline is not None and elapsed > deadline
        # cosine-shift accept gate: a release pointing away from the host's
        # own rows is poison even if the backtrack score would admit it
        poisoned = (mean_cos is not None and not straggled
                    and mean_cos < self._cos_tau(client))
        accepted = after > before and not straggled and not poisoned
        if accepted:  # Backtrack (Alg. 1 l. 17)
            self.best_score[host] = after
            self.best_snapshot[host] = hos_tr.snapshot()
        else:
            hos_tr.restore(self.best_snapshot[host])
        if self.state[host] is NodeState.BUSY:
            self.state[host] = NodeState.READY
        fault_kind = "straggle" if straggled else ("poison" if poisoned else None)
        ev = FederationEvent(
            self._tick, host, client, "ppat", before, after, accepted,
            epsilon=hist["epsilon"], seconds=elapsed, fault=fault_kind,
            attack=attack.kind if attack is not None else None,
        )
        self.events.append(ev)
        if accepted:
            self.broadcast(host)
            self._rep_recover(host, client)
            self._notify_accept(host)
        if fault_kind is None:
            self._note_entry_ok(host, client)
        return ev

    def _draw_ppat(self, host: str, client: str) -> tuple:
        """One handshake's PPAT inputs ``(init, PPATDraws)``: from the draw
        source, else from the scheduler's generator, in the order
        ``train_ppat`` would draw them itself (discriminators, then rounds).
        The row counts come from the registry."""
        n = self.registry.num_aligned(client, host)
        if self._draws is not None:
            return self._draws.ppat(host, client, n, n)
        dim = self.trainers[client].params["ent"].shape[1]
        return (_init_host_params(self._ppat_gen, dim, self.ppat_cfg),
                draw_ppat(self._ppat_gen, self.ppat_cfg, n, n))

    def self_train_once(self, name: str, *, fault=None,
                        deadline: Optional[float] = None) -> FederationEvent:
        """Alg. 1 ll. 23–27: local iterative training when the queue is empty."""
        t0 = time.perf_counter()
        if fault is not None and fault.kind == "crash":
            raise FaultError("crash", name, None)
        tr = self.trainers[name]
        self._train(name, self.update_epochs)
        before = self.best_score[name]
        after = self.score_fn(name)
        self._sync()
        elapsed = time.perf_counter() - t0
        if fault is not None and fault.kind == "straggle":
            elapsed += fault.delay
        straggled = deadline is not None and elapsed > deadline
        accepted = after > before and not straggled
        if accepted:
            self.best_score[name] = after
            self.best_snapshot[name] = tr.snapshot()
            self.broadcast(name)
            self._notify_accept(name)
        else:
            tr.restore(self.best_snapshot[name])
        ev = FederationEvent(
            self._tick, name, None, "self-train", before, after, accepted,
            seconds=elapsed, fault="straggle" if straggled else None,
        )
        self.events.append(ev)
        if not straggled:
            self._note_entry_ok(name)
        return ev

    # -------------------------------------------------- failure semantics
    def _note_entry_ok(self, host: str, client: Optional[str] = None) -> None:
        """A completed entry clears its pair's backoff and both participants'
        consecutive-failure counts."""
        self._retries.pop((host, client), None)
        self._peer_failures.pop(host, None)
        if client is not None:
            self._peer_failures.pop(client, None)

    def _entry_failed(self, host: str, client: Optional[str], fault_kind: str, *,
                      emit: bool = True) -> None:
        """Isolate one failed entry: restore the host's best snapshot, emit
        the fault event, re-queue the handshake with exponential backoff,
        and blame a peer (crash/straggle → host, corrupt/poison → the sending
        client, drop → nobody), decaying its reputation and quarantining it
        at ``retry_budget`` consecutive failures."""
        snap = self.best_snapshot.get(host)
        if snap is not None:
            self.trainers[host].restore(snap)
        if self.state[host] is NodeState.BUSY:
            self.state[host] = NodeState.READY
        if emit:
            before = self.best_score.get(host, float("nan"))
            self.events.append(FederationEvent(
                self._tick, host, client, "ppat" if client is not None else "self-train",
                before, before, False, fault=fault_kind,
            ))
        if client is not None:
            att = self._retries.get((host, client), 0) + 1
            self._retries[(host, client)] = att
            release = self._tick + self.backoff_ticks * (2 ** min(att - 1, 6))
            self._deferred.append((release, host, client))
        peer = {"corrupt": client, "poison": client, "drop": None}.get(fault_kind, host)
        if peer is not None:
            self._reputation[peer] = self._reputation.get(peer, 1.0) * self.rep_decay
            n = self._peer_failures.get(peer, 0) + 1
            self._peer_failures[peer] = n
            if n >= self.retry_budget:
                self._quarantine(peer)

    def _rep_recover(self, *peers: str) -> None:
        """Accepted handshakes repair both participants' reputation; entries
        reaching 1.0 are dropped so the map stays sparse."""
        for p in peers:
            r = self._reputation.get(p)
            if r is None:
                continue
            r += self.rep_recover
            if r >= 1.0:
                del self._reputation[p]
            else:
                self._reputation[p] = r

    @property
    def _defended(self) -> bool:
        """Whether the Byzantine defenses are armed: reputation changes a
        decision only then."""
        return self.robust_agg != "none" or self.cos_screen is not None

    def _cos_tau(self, client: str) -> float:
        """The cosine-shift threshold for this client: ``cos_screen``
        sharpened toward 1 as the client's reputation decays."""
        if self.cos_screen is None:
            return -1.0
        rep = self._reputation.get(client, 1.0)
        return 1.0 - rep * (1.0 - self.cos_screen)

    def _quarantine(self, peer: str) -> None:
        """Expel a repeatedly failing peer for ``quarantine_ticks`` ticks."""
        self.state[peer] = NodeState.QUARANTINED
        self._quarantine_until[peer] = self._tick + self.quarantine_ticks
        self._peer_failures.pop(peer, None)

    def _release_due(self) -> None:
        """Timed releases at plan time: expired quarantines return to READY,
        and deferred offers whose backoff lapsed re-enter their host's queue
        (deduped, waking a sleeping host)."""
        for peer, until in list(self._quarantine_until.items()):
            if self._tick >= until:
                del self._quarantine_until[peer]
                if self.state[peer] is NodeState.QUARANTINED:
                    self.state[peer] = NodeState.READY
        still: List[tuple] = []
        for release, host, client in self._deferred:
            if self._tick < release:
                still.append((release, host, client))
                continue
            if client not in self._queued[host]:
                self.queue[host].append(client)
                self._queued[host].add(client)
            if self.state[host] is NodeState.SLEEP:
                self.state[host] = NodeState.READY
        self._deferred = still

    def _next_offer(self, name: str) -> Optional[str]:
        """Front-of-queue client for this owner; offers from quarantined
        clients are deferred to their release, not dropped. With the
        defenses armed and some reputation below 1, the best-reputed queued
        client is served first (FIFO among ties)."""
        if self._defended and self._reputation and self.queue[name]:
            best = max(self._reputation.get(c, 1.0) for c in self.queue[name])
            for client in self.queue[name]:
                if self._reputation.get(client, 1.0) == best:
                    self.queue[name].remove(client)
                    self._queued[name].discard(client)
                    if self.state.get(client) is NodeState.QUARANTINED:
                        release = self._quarantine_until.get(client, self._tick + 1)
                        self._deferred.append((release, name, client))
                        return self._next_offer(name)
                    return client
        while self.queue[name]:
            client = self._pop_offer(name)
            if self.state.get(client) is NodeState.QUARANTINED:
                release = self._quarantine_until.get(client, self._tick + 1)
                self._deferred.append((release, name, client))
                continue
            return client
        return None

    def _unwind_plan(self, plan: List[TickEntry], done) -> None:
        """Put a plan's un-executed remainder back where ``plan_tick`` found
        it (offers to the front of their queue in plan order, BUSY hosts to
        READY), so the scheduler stays re-runnable after an unexpected error."""
        for e in reversed(plan):
            if e.host in done:
                continue
            if e.kind == "ppat" and e.client not in self._queued[e.host]:
                self.queue[e.host].appendleft(e.client)
                self._queued[e.host].add(e.client)
            if self.state[e.host] is NodeState.BUSY:
                self.state[e.host] = NodeState.READY

    def _fault_injector(self, tick_faults=None) -> Optional[FaultInjector]:
        """Resolve the fault layer (call-site argument > constructor > env)
        to a cached ``FaultInjector``, or ``None`` when off."""
        src = resolve_tick_faults(tick_faults if tick_faults is not None else self.tick_faults)
        if src is None:
            self._injector = self._injector_src = None
            return None
        if isinstance(src, FaultInjector):
            self._injector = self._injector_src = src
            return src
        if self._injector is not None and self._injector_src == src:
            return self._injector
        plan = src if isinstance(src, FaultPlan) else FaultPlan.parse(src)
        self._injector = FaultInjector(plan)
        self._injector_src = src
        return self._injector

    def _adversary_for(self, tick_adversary=None) -> Optional[Adversary]:
        """Resolve the adversary (call-site argument > constructor > env) to
        a cached ``Adversary``, or ``None`` when off. The cache keeps the
        replay cache across ``run()`` calls."""
        src = resolve_tick_adversary(
            tick_adversary if tick_adversary is not None else self.tick_adversary)
        if src is None:
            self._adversary = self._adversary_src = None
            return None
        if isinstance(src, Adversary):
            self._adversary = self._adversary_src = src
            return src
        if self._adversary is not None and self._adversary_src == src:
            return self._adversary
        self._adversary = resolve_adversary(src)
        self._adversary_src = src
        return self._adversary

    def screen_incoming(self, host: str, client: str, view: Dict, *, bound: float) -> None:
        """The receiver's acceptance screen on an incoming client view, run
        before any PPAT draw: every row the host will read must be finite
        and inside the norm bound, else ``CorruptEmbeddingError`` blames the
        client."""
        ent = view["ent"]
        rows = ent[as_device(self._tick_engine._pair_info(client, host)["screen_idx"], ent.device)]
        screen_rows(rows, bound=bound, host=host, client=client, what="client embeddings")

    # -------------------------------------------------------------- loop
    def plan_tick(self, *, self_train: bool = True) -> List[TickEntry]:
        """This tick's work from the current protocol state: every Ready
        owner contributes one entry (front-of-queue handshake, else
        self-train); owners with nothing to do go to Sleep. Offers are popped
        and client tables copied now. Expired quarantines and backoffs are
        released first."""
        self._release_due()
        entries: List[TickEntry] = []
        for name in self.trainers:
            if self.state[name] is not NodeState.READY:
                continue
            client = self._next_offer(name)
            if client is not None:
                entries.append(self._handshake_entry(name, client))
            elif self_train:
                entries.append(TickEntry(name, "self-train"))
            else:
                self.state[name] = NodeState.SLEEP
        return entries

    def _handshake_entry(self, host: str, client: str) -> TickEntry:
        """A handshake entry with the client's tables frozen now."""
        return TickEntry(host, "ppat", client,
                         client_view=self.trainers[client].snapshot(),
                         view_version=self._view_version.get(client, 0),
                         sim_wait=self._publish_sim.get(client, 0.0))

    def run(
        self,
        max_ticks: int = 6,
        *,
        self_train: bool = True,
        tick_impl: Optional[str] = None,
        tick_placement: Optional[str] = None,
        tick_residency: Optional[str] = None,
        tick_faults=None,
        tick_adversary=None,
        tick_sync: Optional[str] = None,
        staleness_bound: Optional[int] = None,
    ) -> Dict[str, float]:
        """Ticks (barrier) or passes (stream) until quiescence (all queues
        empty, no improvement, nothing deferred or quarantined) or
        ``max_ticks``. The call-site knobs override the constructor's for
        this run; ``tick_faults`` (a spec / ``FaultPlan`` /
        ``FaultInjector``) arms the fault layer, ``tick_adversary`` (a spec
        / ``AdversaryPlan`` / ``Adversary``) the adversary, and
        ``staleness_bound`` gates streamed views.

        One failing entry never aborts its tick (``_entry_failed``); an
        unexpected exception puts the plan's un-executed remainder back into
        the queues before it propagates."""
        impl = resolve_tick_impl(tick_impl if tick_impl is not None else self.tick_impl)
        sync = resolve_tick_sync(tick_sync if tick_sync is not None else self.tick_sync)
        placement = tick_placement if tick_placement is not None else self.tick_placement
        residency = tick_residency if tick_residency is not None else self.tick_residency
        resolve_tick_placement(placement)
        resolve_tick_residency(residency)
        bound = self.staleness_bound if staleness_bound is None else int(staleness_bound)
        if bound < 0:
            raise ValueError(f"staleness_bound={bound} must be >= 0")
        if impl == "batched" and any(
                resolve_train_impl(None, tr.model.family) == "reference"
                for tr in self.trainers.values()):
            # checked before any plan pops an offer
            raise ValueError("tick_impl='batched' cannot run the 'reference' training step "
                             "(REPRO_TRAIN_IMPL=reference); run with tick_impl='reference'")
        injector = self._fault_injector(tick_faults)
        adversary = self._adversary_for(tick_adversary)

        def execute(entries: List[TickEntry]) -> List[FederationEvent]:
            if impl == "reference":
                return self._run_serial(entries, injector, adversary, self.tick_deadline)
            return self._tick_engine.execute(
                entries, self._tick, placement=placement, residency=residency,
                faults=injector, adversary=adversary, deadline=self.tick_deadline)

        if sync == "stream":
            return self._run_stream(max_ticks, self_train=self_train, injector=injector,
                                    bound=bound, execute=execute)
        for _ in range(max_ticks):
            self._tick += 1
            with tracing.span("tick") as sp:
                if sp:
                    sp.set(tick=self._tick)
                with tracing.span("tick.plan"):
                    plan = self.plan_tick(self_train=self_train)
                try:
                    events = execute(plan)
                except Exception:
                    self._unwind_plan(plan,
                                      {ev.host for ev in self.events if ev.tick == self._tick})
                    raise
                self._stamp_events(plan, events, level=0)
                self._sim_account_barrier(events)
            if (
                not any(ev.accepted for ev in events)
                and all(not q for q in self.queue.values())
                and not self._deferred
                and not self._quarantine_until
            ):
                break  # "whole training continues until no more improvement"
        return dict(self.best_score)

    def _stamp_events(self, entries: List[Optional[TickEntry]],
                      events: List[FederationEvent], *, level: int) -> None:
        """Stamp fresh events with their level, the host's advanced clock and
        the view version the entry read (handshakes) or the host's own."""
        for e, ev in zip(entries, events):
            clk = self._owner_clock.get(ev.host, 0) + 1
            self._owner_clock[ev.host] = clk
            ev.level = level
            ev.owner_clock = clk
            if e is not None and e.kind == "ppat":
                ev.view_version = e.view_version
            else:
                ev.view_version = self._view_version.get(ev.host, 0)

    def _sim_account_barrier(self, events: List[FederationEvent]) -> None:
        """Barrier time model (reporting only): a tick's participants start
        together once the last is free and finish after the slowest entry."""
        if not events:
            return
        hosts = {ev.host for ev in events}
        start = max(self._owner_free.get(h, 0.0) for h in hosts)
        fin = start + max(ev.seconds for ev in events)
        for h in hosts:
            self._owner_free[h] = fin
        for ev in events:
            ev.sim_finish = fin
            if ev.accepted:
                self._publish_sim[ev.host] = fin

    def _sim_account_stream(self, entries: List[TickEntry],
                            events: List[FederationEvent]) -> None:
        """Streamed time model (reporting only): an entry starts once its
        host is free and the client version it read was published."""
        for e, ev in zip(entries, events):
            start = max(self._owner_free.get(ev.host, 0.0), e.sim_wait)
            fin = start + max(ev.seconds, 0.0)
            self._owner_free[ev.host] = fin
            ev.sim_finish = fin
            if ev.accepted:
                self._publish_sim[ev.host] = fin

    def sim_times(self) -> Dict[str, float]:
        """Per-owner simulated completion times (reporting only)."""
        return dict(self._owner_free)

    def sim_makespan(self) -> float:
        """Simulated federation makespan: when the last owner goes idle."""
        return max(self._owner_free.values(), default=0.0)

    # ------------------------------------------------- streaming scheduler
    @staticmethod
    def _cut_levels(plan: List[TickEntry]) -> List[List[TickEntry]]:
        """Cut a pass's plan into dependency levels: an entry lands one
        level past the last earlier entry sharing a participant (host or
        client) with it, so overlapping entries serialize in plan order and
        disjoint ones share a level."""
        levels: List[List[TickEntry]] = []
        last: Dict[str, int] = {}
        for e in plan:
            parts = {e.host} if e.client is None else {e.host, e.client}
            k = max((last[p] + 1 for p in parts if p in last), default=0)
            while len(levels) <= k:
                levels.append([])
            levels[k].append(e)
            for p in parts:
                last[p] = k
        return levels

    def _assign_entry_draws(self, entries: List[TickEntry],
                            injector: Optional[FaultInjector]) -> None:
        """Draw the PPAT inputs of a streamed pass's handshakes in plan
        order, so the levels consume the draw source in the order the
        barrier would. Entries whose fault kills them before any draw
        (crash, drop, corrupt) are skipped; the draw here reads the
        stateless plan, so the injector's counts stay single."""
        for e in entries:
            if e.kind != "ppat" or e.ppat_draws is not None:
                continue
            if injector is not None:
                f = injector.plan.draw(self._tick, e.host, e.client)
                if f is not None and f.kind in ("crash", "drop", "corrupt"):
                    continue
            e.ppat_draws = self._draw_ppat(e.host, e.client)

    def _run_stream(self, max_ticks: int, *, self_train: bool,
                    injector: Optional[FaultInjector], bound: int,
                    execute: Callable[[List[TickEntry]], List[FederationEvent]]
                    ) -> Dict[str, float]:
        """Dependency-level streaming passes (``tick_sync="stream"``).

        Each pass plans like a barrier tick, cuts the plan into levels and
        runs them in order through ``execute`` (the chosen engine). At each level a
        handshake whose frozen view is more than ``bound`` versions behind
        its client emits a ``fault="stale"`` audit event and re-offers: a
        fresh view is frozen and runs in a trailing level of this pass;
        stale again, the offer goes back to the front of the host's queue
        for the next pass. Stale-gated entries take no fault draw, and the
        PPAT inputs they drew go unused."""
        for _ in range(max_ticks):
            self._tick += 1
            plan = self.plan_tick(self_train=self_train)
            self._assign_entry_draws(plan, injector)
            pending = [list(lv) for lv in self._cut_levels(plan)]
            pass_events: List[FederationEvent] = []
            reoffered: set = set()
            lvl = 0
            while pending:
                live: List[TickEntry] = []
                reoffer_level: List[TickEntry] = []
                for e in pending.pop(0):
                    if (e.kind == "ppat"
                            and self._view_version.get(e.client, 0) - e.view_version > bound):
                        before = self.best_score.get(e.host, float("nan"))
                        ev = FederationEvent(self._tick, e.host, e.client, "ppat",
                                             before, before, False, fault="stale")
                        self.events.append(ev)
                        self._stamp_events([e], [ev], level=lvl)
                        pass_events.append(ev)
                        if (e.host, e.client) not in reoffered:
                            reoffered.add((e.host, e.client))
                            reoffer_level.append(self._handshake_entry(e.host, e.client))
                        elif e.client not in self._queued[e.host]:
                            self.queue[e.host].appendleft(e.client)
                            self._queued[e.host].add(e.client)
                        continue
                    live.append(e)
                if reoffer_level:
                    # re-frozen views run after everything already scheduled;
                    # their inputs are drawn now, in level order
                    self._assign_entry_draws(reoffer_level, injector)
                    pending.append(reoffer_level)
                if live:
                    try:
                        events = execute(live)
                    except Exception:
                        done = {ev.host for ev in self.events
                                if ev.tick == self._tick and ev.fault != "stale"}
                        self._unwind_plan(live + [e for lv in pending for e in lv], done)
                        raise
                    self._stamp_events(live, events, level=lvl)
                    self._sim_account_stream(live, events)
                    pass_events.extend(events)
                lvl += 1
            if (
                not any(ev.accepted for ev in pass_events)
                and all(not q for q in self.queue.values())
                and not self._deferred
                and not self._quarantine_until
            ):
                break
        return dict(self.best_score)

    def _run_serial(self, plan: List[TickEntry], injector: Optional[FaultInjector],
                    adversary: Optional[Adversary],
                    deadline: Optional[float]) -> List[FederationEvent]:
        """A tick's (or a level's) entries in order, each failure isolated.
        Order per entry: frozen view → adversary tamper → fault corruption →
        receiver screen, all before any PPAT draw."""
        events: List[FederationEvent] = []
        done: set = set()
        screen = injector.norm_bound if injector is not None else None
        for e in plan:
            fault = injector.draw(self._tick, e.host, e.client) if injector is not None else None
            attack = (adversary.draw(self._tick, e.host, e.client)
                      if adversary is not None and e.kind == "ppat" else None)
            view = e.client_view
            if attack is not None:
                view = adversary.tamper_view(view, attack, self._tick, e.host, e.client,
                                             rows=self._tick_engine._pair_info(
                                                 e.client, e.host)["screen_idx"])
            if fault is not None and fault.kind == "corrupt" and e.kind == "ppat":
                view = injector.corrupt_view(view, fault, self._tick, e.host)
            try:
                if e.kind == "ppat":
                    if injector is not None:
                        self.screen_incoming(e.host, e.client, view, bound=screen)
                    ev = self.federate_once(e.host, e.client, client_view=view, fault=fault,
                                            attack=attack, screen=screen, deadline=deadline,
                                            ppat_draws=e.ppat_draws)
                else:
                    ev = self.self_train_once(e.host, fault=fault, deadline=deadline)
            except FaultError as fe:
                self._entry_failed(e.host, e.client, fe.kind)
                done.add(e.host)
                events.append(self.events[-1])
                continue
            except Exception:
                snap = self.best_snapshot.get(e.host)
                if snap is not None:
                    self.trainers[e.host].restore(snap)
                self._unwind_plan(plan, done)
                raise
            done.add(e.host)
            events.append(ev)
            if ev.fault in ("straggle", "poison"):
                self._entry_failed(e.host, e.client, ev.fault, emit=False)
        return events
