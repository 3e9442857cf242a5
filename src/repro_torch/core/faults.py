"""Seeded chaos for the federation scheduler and the serving query path:
the JAX package's ``core/faults.py``, kept as its own numpy copy.

Federation fault kinds (one per tick entry at most):

  * ``crash``    — the host dies mid-entry: the entry raises before any PPAT
                   draw is taken; the scheduler restores the host's snapshot
                   and re-queues the handshake with exponential backoff.
  * ``straggle`` — the entry completes late: a simulated delay is added to
                   its measured wall-clock (never slept), and a configured
                   ``tick_deadline`` discards the result and defers the pair.
  * ``drop``     — the client's PPAT message is lost: re-queued like a crash,
                   blaming nobody.
  * ``corrupt``  — the client's embeddings arrive damaged (NaN or far past
                   the norm bound); the receiver's screen (``screen_rows``)
                   rejects the handshake and blames the client.

Every draw is a pure function of its key through ``np.random.default_rng``
— ``(seed, tick, host, client)`` for a federation entry, ``(seed, batch,
replica)`` for a serving batch — so a plan injects the same faults as the
JAX package's ``FaultPlan``/``ServeFaultPlan`` and replays byte-identically.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

#: fixed draw order — segment boundaries of the uniform draw; reordering
#: would silently change every seeded plan
FAULT_KINDS = ("crash", "straggle", "drop", "corrupt")

#: row-norm screen default: entity tables are renormalized toward unit norm
#: every epoch, so anything beyond this is not an embedding
DEFAULT_NORM_BOUND = 1e3


class FaultError(RuntimeError):
    """An injected (or detected) fault for one tick entry."""

    def __init__(self, kind: str, host: str, client: Optional[str] = None):
        super().__init__(f"fault[{kind}] host={host} client={client}")
        self.kind = kind
        self.host = host
        self.client = client


class CorruptEmbeddingError(FaultError):
    """Incoming client embeddings failed the non-finite / norm-bound screen."""

    def __init__(self, host: str, client: Optional[str], detail: str):
        super().__init__("corrupt", host, client)
        self.detail = detail


@dataclass(frozen=True)
class Fault:
    """One injected fault. ``delay`` is the straggle's simulated seconds;
    ``rows`` / ``mode`` shape the corruption (NaN vs out-of-norm garbage)."""

    kind: str
    delay: float = 0.0
    rows: int = 4
    mode: str = "nan"  # "nan" | "garbage"


def _stable_u32(s: str) -> int:
    """Process- and platform-stable string hash (Python's ``hash`` is salted
    per process)."""
    return zlib.crc32(s.encode("utf-8")) & 0xFFFFFFFF


@dataclass(frozen=True)
class FaultPlan:
    """A seeded chaos schedule: per-entry fault rates plus an optional
    explicit ``table`` of pinned ``(tick, host) -> Fault``. ``until`` bounds
    the chaos window (ticks past it inject nothing)."""

    crash: float = 0.0
    straggle: float = 0.0
    drop: float = 0.0
    corrupt: float = 0.0
    seed: int = 0
    until: Optional[int] = None   # last tick (inclusive) that injects
    delay: float = 1.0            # straggle: simulated seconds
    rows: int = 4                 # corrupt: damaged row count
    mode: str = "nan"             # corrupt: "nan" | "garbage"
    norm_bound: float = DEFAULT_NORM_BOUND
    table: Optional[Dict[Tuple[int, str], Fault]] = field(default=None)

    def __post_init__(self):
        for k in FAULT_KINDS:
            r = getattr(self, k)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"fault rate {k}={r} outside [0, 1]")
        if self.mode not in ("nan", "garbage"):
            raise ValueError(f"corrupt mode {self.mode!r} (nan|garbage)")

    def draw(self, tick: int, host: str, client: Optional[str]) -> Optional[Fault]:
        """The fault (if any) for this tick entry — a pure function of
        ``(seed, tick, host, client)``. ``drop``/``corrupt`` only apply to
        handshake entries (a self-train sends no message)."""
        if self.table is not None:
            hit = self.table.get((tick, host))
            if hit is not None:
                if client is None and hit.kind in ("drop", "corrupt"):
                    return None
                return hit
        if self.until is not None and tick > self.until:
            return None
        rng = np.random.default_rng(
            (self.seed, tick, _stable_u32(host), _stable_u32(client or ""))
        )
        u = float(rng.random())
        lo = 0.0
        for kind in FAULT_KINDS:
            hi = lo + getattr(self, kind)
            if lo <= u < hi:
                if client is None and kind in ("drop", "corrupt"):
                    return None
                return Fault(kind, delay=self.delay, rows=self.rows, mode=self.mode)
            lo = hi
        return None

    @classmethod
    def slow_owner(cls, host: str, *, delay: float, ticks: int,
                   first_tick: int = 1) -> "FaultPlan":
        """One pinned slow owner: ``host`` draws a simulated-``delay``
        straggle whenever it hosts an entry in ticks ``first_tick ..
        first_tick + ticks - 1``; every other owner runs clean."""
        table = {
            (t, host): Fault("straggle", delay=float(delay))
            for t in range(first_tick, first_tick + ticks)
        }
        return cls(table=table)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the ``REPRO_TICK_FAULTS`` / ``tick_faults=``
        grammar: comma-separated ``key=value`` pairs, e.g.
        ``"crash=0.2,straggle=0.1,corrupt=0.1,seed=7,until=6,delay=0.5"``.
        Bare ``"on"`` arms the layer (screens + hooks) with no injection."""
        kw: Dict[str, object] = {}
        spec = spec.strip()
        if spec.lower() in ("on", "screen"):
            return cls()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad tick_faults clause {part!r} (key=value)")
            k, v = (s.strip() for s in part.split("=", 1))
            if k in FAULT_KINDS + ("delay", "norm_bound"):
                kw[k] = float(v)
            elif k in ("seed", "until", "rows"):
                kw[k] = int(v)
            elif k == "mode":
                kw[k] = v
            else:
                raise ValueError(f"unknown tick_faults key {k!r}")
        return cls(**kw)  # type: ignore[arg-type]


class FaultInjector:
    """Per-scheduler wrapper around a :class:`FaultPlan`: draws faults,
    damages client views, and counts injections per kind (telemetry only:
    counts never feed back into draws)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {}

    @property
    def norm_bound(self) -> float:
        return self.plan.norm_bound

    def draw(self, tick: int, host: str, client: Optional[str] = None
             ) -> Optional[Fault]:
        f = self.plan.draw(tick, host, client)
        if f is not None:
            self.counts[f.kind] = self.counts.get(f.kind, 0) + 1
        return f

    def corrupt_view(self, params: Dict[str, torch.Tensor], fault: Fault, tick: int,
                     host: str) -> Dict[str, torch.Tensor]:
        """A damaged copy of a client view: ``rows`` entity rows become NaN
        (``mode="nan"``) or garbage ten times past the norm bound
        (``mode="garbage"``), chosen by numpy from ``(seed, tick, host)``.
        The other tables are shared; the entity table comes back on the
        view's device."""
        rng = np.random.default_rng(
            (self.plan.seed + 0x5EED, tick, _stable_u32(host))
        )
        src = params["ent"]
        ent = np.array(src.detach().cpu().numpy(), dtype=np.float32, copy=True)
        n = min(max(1, fault.rows), ent.shape[0])
        idx = rng.choice(ent.shape[0], size=n, replace=False)
        if fault.mode == "nan":
            ent[idx] = np.nan
        else:
            ent[idx] = rng.standard_normal((n, ent.shape[1])).astype(
                np.float32
            ) * (10.0 * self.plan.norm_bound)
        out = dict(params)
        out["ent"] = torch.from_numpy(ent).to(src.device)
        return out


def screen_rows(rows, *, bound: float, host: str, client: Optional[str],
                what: str = "embeddings") -> None:
    """Receiver-side integrity screen on exchanged embedding rows: reject
    non-finite values and row norms beyond ``bound`` with
    :class:`CorruptEmbeddingError`. The rows are read back to the host once
    and checked there in numpy, as the JAX package checks them."""
    a = rows.detach().cpu().numpy() if torch.is_tensor(rows) else np.asarray(rows)
    if a.size == 0:
        return
    if not np.isfinite(a).all():
        raise CorruptEmbeddingError(
            host, client, f"non-finite values in incoming {what}"
        )
    worst = float(np.max(np.linalg.norm(a.reshape(a.shape[0], -1), axis=1)))
    if worst > bound:
        raise CorruptEmbeddingError(
            host, client,
            f"incoming {what} row norm {worst:.3g} exceeds bound {bound:.3g}",
        )


#: fixed draw order — segment boundaries of the uniform draw; reordering
#: would silently change every seeded storm
SERVE_FAULT_KINDS = ("crash", "straggle", "poison")


class ServeFaultError(RuntimeError):
    """An injected (or detected) fault for one dispatched serving batch."""

    def __init__(self, kind: str, batch: int, replica: int):
        super().__init__(f"serve fault[{kind}] batch={batch} replica={replica}")
        self.kind = kind
        self.batch = batch
        self.replica = replica


@dataclass(frozen=True)
class ServeFault:
    """One injected serving fault. ``delay`` is the straggle's simulated
    seconds of suppressed readiness; ``rows`` is how many output rows the
    poison damages."""

    kind: str
    delay: float = 0.0
    rows: int = 1


@dataclass(frozen=True)
class ServeFaultPlan:
    """A seeded chaos schedule for the query path. Fault kinds (at most one
    per dispatched batch):

      * ``crash``    — collection raises; the tier re-dispatches the batch to
                       a different replica on the same pinned table version.
      * ``straggle`` — the batch reports not-ready until ``delay`` simulated
                       seconds after dispatch (exercises hedging; never added
                       to the device work).
      * ``poison``   — ``rows`` result rows are corrupted after collection;
                       the armed output screen must catch them and retry.

    ``batch`` is the tier's monotone launch sequence number, so retries and
    hedges re-draw independently. ``until`` bounds the storm to launch
    numbers ``<= until``; ``table`` pins ``(batch, replica) -> ServeFault``
    for scenario tests.
    """

    crash: float = 0.0
    straggle: float = 0.0
    poison: float = 0.0
    seed: int = 0
    until: Optional[int] = None   # last launch seq (inclusive) that injects
    delay: float = 0.05           # straggle: simulated seconds
    rows: int = 1                 # poison: damaged output rows
    table: Optional[Dict[Tuple[int, int], ServeFault]] = field(default=None)

    def __post_init__(self):
        for k in SERVE_FAULT_KINDS:
            r = getattr(self, k)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"serve fault rate {k}={r} outside [0, 1]")

    def draw(self, batch: int, replica: int) -> Optional[ServeFault]:
        """The fault (if any) for one dispatched batch — a pure function of
        ``(seed, batch, replica)``."""
        if self.table is not None:
            hit = self.table.get((batch, replica))
            if hit is not None:
                return hit
        if self.until is not None and batch > self.until:
            return None
        if not (self.crash or self.straggle or self.poison):
            return None
        rng = np.random.default_rng((self.seed, 0x5E57E, batch, replica))
        u = float(rng.random())
        lo = 0.0
        for kind in SERVE_FAULT_KINDS:
            hi = lo + getattr(self, kind)
            if lo <= u < hi:
                return ServeFault(kind, delay=self.delay, rows=self.rows)
            lo = hi
        return None

    @classmethod
    def parse(cls, spec: str) -> "ServeFaultPlan":
        """Build a plan from the ``REPRO_SERVE_FAULTS`` / ``serve_faults=``
        grammar: comma-separated ``key=value`` pairs, e.g.
        ``"crash=0.2,straggle=0.1,poison=0.1,seed=7,until=40,delay=0.05"``.
        Bare ``"on"`` arms the layer (output screens + draws) with no
        injection."""
        kw: Dict[str, object] = {}
        spec = spec.strip()
        if spec.lower() in ("on", "screen"):
            return cls()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad serve_faults clause {part!r} (key=value)")
            k, v = (s.strip() for s in part.split("=", 1))
            if k in SERVE_FAULT_KINDS + ("delay",):
                kw[k] = float(v)
            elif k in ("seed", "until", "rows"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown serve_faults key {k!r}")
        return cls(**kw)  # type: ignore[arg-type]
