"""Byzantine peer model for the federation — seeded, deterministic attacks:
the JAX package's ``core/adversary.py``, its draws kept in numpy.

The fault layer (``core.faults``) models *random* failure; this module
models *adversarial* peers. Every strategy here stays strictly inside the
receiver's ``screen_rows`` norm bound, so the undefended path accepts the
message and only the robust acceptance layer (``robust_agg`` /
``cos_screen`` / reputation gating in ``core.federation``) can reject it.

Attack kinds (at most one per handshake entry):

  * ``drift``  — norm-evading targeted drift: the attacked client's shipped
                 rows are blended toward a persistent per-client random
                 direction, row norms capped at ``evade * bound``. ``frac``
                 poisons only a seeded subset of the rows.
  * ``sybil``  — colluding drift: like ``drift``, but every sybil peer
                 shares ONE group direction (seeded by the plan alone).
  * ``replay`` — stale-view replay: the first view a peer ships per
                 (client, host) pair is cached and re-shipped on later
                 replay draws.

Determinism: ``AdversaryPlan.draw`` is a pure function of ``(seed, tick,
host, client)`` (``np.random.default_rng``, as ``FaultPlan.draw``), and
``tamper_view`` derives all its randomness from the plan seed, so a storm
tampers the same rows with the same numbers as the JAX package's. The only
adversary state is the replay cache (host numpy copies), which
``checkpoint.save_scheduler`` writes so that a resumed storm replays the
same stale views. The lockstep is per entry: a streamed pass may tamper the
same ``(tick, host, client)`` twice (a re-offer re-freezes a fresh view),
and because draws and directions are pure in those coordinates the storm is
the same under either scheduling discipline.

``tamper_view`` touches only the rows the host will read. It gathers those
rows from the view's device, does the JAX package's numpy arithmetic on
them on the host, and scatters the result into a copy of the view's entity
table: the frozen view itself is never written, since the replay cache and a
re-offer may read it.

Resolution: ``kernels.dispatch.resolve_tick_adversary`` /
``REPRO_TICK_ADVERSARY`` / ``FederationScheduler(tick_adversary=...)``;
off by default, when every hook is an ``is None`` check.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.faults import DEFAULT_NORM_BOUND, _stable_u32

#: fixed draw order — segment boundaries of the uniform draw; reordering
#: would silently change every seeded storm
ATTACK_KINDS = ("drift", "sybil", "replay")


@dataclass(frozen=True)
class Attack:
    """One drawn attack. ``strength`` is the drift blend factor γ (0 = no-op,
    1 = pure adversarial direction); ``evade`` scales the norm cap relative
    to the receiver's screen bound; ``frac`` is the poisoned-row fraction."""

    kind: str
    strength: float = 0.5
    evade: float = 0.9
    frac: float = 1.0


@dataclass(frozen=True)
class AdversaryPlan:
    """A seeded adversarial-peer schedule: per-entry attack rates plus an
    optional explicit ``table`` of pinned ``(tick, host) -> Attack``.

    ``peers`` restricts which clients behave adversarially (empty = any
    client may draw an attack). ``until`` bounds the storm window like
    ``FaultPlan.until``."""

    drift: float = 0.0
    sybil: float = 0.0
    replay: float = 0.0
    peers: Tuple[str, ...] = ()
    seed: int = 0
    until: Optional[int] = None      # last tick (inclusive) that attacks
    strength: float = 0.5            # drift blend γ
    evade: float = 0.9               # norm cap = evade * screen bound
    frac: float = 1.0                # poisoned-row fraction per attack
    bound: float = DEFAULT_NORM_BOUND
    table: Optional[Dict[Tuple[int, str], Attack]] = field(default=None)

    def __post_init__(self):
        for k in ATTACK_KINDS:
            r = getattr(self, k)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"attack rate {k}={r} outside [0, 1]")
        for k in ("evade", "frac"):
            v = getattr(self, k)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{k}={v} outside (0, 1]")
        if not 0.0 <= self.strength <= 1.0:
            raise ValueError(f"strength={self.strength} outside [0, 1]")

    def draw(self, tick: int, host: str, client: Optional[str]) -> Optional[Attack]:
        """The attack (if any) this peer mounts against this tick entry — a
        pure function of ``(seed, tick, host, client)``. Self-train entries
        (``client=None``) and clients outside ``peers`` never attack."""
        if client is None:
            return None
        if self.peers and client not in self.peers:
            return None
        if self.table is not None:
            hit = self.table.get((tick, host))
            if hit is not None:
                return hit
        if self.until is not None and tick > self.until:
            return None
        # a distinct stream from FaultPlan's (offset first element), so an
        # adversary layered over a fault storm with the same seed draws
        # independently
        rng = np.random.default_rng(
            (self.seed + 0xAD7E, tick, _stable_u32(host), _stable_u32(client or ""))
        )
        u = float(rng.random())
        lo = 0.0
        for kind in ATTACK_KINDS:
            hi = lo + getattr(self, kind)
            if lo <= u < hi:
                return Attack(kind, strength=self.strength, evade=self.evade, frac=self.frac)
            lo = hi
        return None

    @classmethod
    def parse(cls, spec: str) -> "AdversaryPlan":
        """Build a plan from the ``REPRO_TICK_ADVERSARY`` / ``tick_adversary=``
        grammar: comma-separated ``key=value`` pairs, e.g.
        ``"drift=0.6,peers=K1+K2,seed=7,until=10,strength=0.8"`` (``peers``
        is ``+``-separated). Bare ``"on"`` arms the layer with zero rates."""
        kw: Dict[str, object] = {}
        spec = spec.strip()
        if spec.lower() == "on":
            return cls()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad tick_adversary clause {part!r} (key=value)")
            k, v = (s.strip() for s in part.split("=", 1))
            if k in ATTACK_KINDS + ("strength", "evade", "frac", "bound"):
                kw[k] = float(v)
            elif k in ("seed", "until"):
                kw[k] = int(v)
            elif k == "peers":
                kw[k] = tuple(p for p in v.split("+") if p)
            else:
                raise ValueError(f"unknown tick_adversary key {k!r}")
        return cls(**kw)  # type: ignore[arg-type]


class Adversary:
    """Per-scheduler wrapper around an :class:`AdversaryPlan`: draws
    attacks, tampers client views, keeps per-kind counts (telemetry only)
    and the replay cache of first-shipped views (the only adversary state
    that feeds back into behaviour; ``checkpoint.save_scheduler`` writes
    it)."""

    def __init__(self, plan: AdversaryPlan):
        self.plan = plan
        self.counts: Dict[str, int] = {}
        #: (client, host) → the first view that pair ever shipped (host numpy
        #: copies; replayed verbatim on later ``replay`` draws)
        self._stale: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}

    def draw(self, tick: int, host: str, client: Optional[str] = None) -> Optional[Attack]:
        a = self.plan.draw(tick, host, client)
        if a is not None:
            self.counts[a.kind] = self.counts.get(a.kind, 0) + 1
        return a

    def _direction(self, client: str, dim: int, kind: str) -> np.ndarray:
        """The drift target: a persistent unit vector, seeded per client for
        ``drift`` and from the plan alone for ``sybil`` (all colluding peers
        push the same way every tick)."""
        if kind == "sybil":
            key: Tuple[int, ...] = (self.plan.seed + 0x5B11,)
        else:
            key = (self.plan.seed + 0xD21F7, _stable_u32(client))
        rng = np.random.default_rng(key)
        d = rng.standard_normal(dim).astype(np.float32)
        return d / max(float(np.linalg.norm(d)), 1e-12)

    def tamper_view(self, view: Dict[str, torch.Tensor], attack: Attack, tick: int,
                    host: str, client: str, *, rows: np.ndarray) -> Dict[str, torch.Tensor]:
        """Apply one drawn attack to a client view, touching exactly the rows
        the host will read (aligned set + virtual neighbours). Returns a new
        dict; ``view``'s tensors are never written. Every produced row is
        finite with norm ≤ ``evade * bound``, so the receiver's integrity
        screen passes by construction."""
        if attack.kind == "replay":
            key = (client, host)
            cached = self._stale.get(key)
            if cached is None:
                # first fire: record what this pair ships today; the attack
                # itself is a no-op this tick
                self._stale[key] = {
                    k: np.array(v.detach().cpu().numpy(), dtype=np.float32, copy=True)
                    for k, v in view.items()
                }
                return view
            dev = view["ent"].device
            return {k: torch.tensor(v, device=dev) for k, v in cached.items()}

        src = view["ent"]
        rows = np.unique(np.asarray(rows, np.int64))
        rows = rows[(rows >= 0) & (rows < src.shape[0])]
        if rows.size == 0:
            return view
        if attack.frac < 1.0:
            # targeted subset, seeded per entry
            rng = np.random.default_rng(
                (self.plan.seed + 0xF2AC, tick, _stable_u32(host), _stable_u32(client))
            )
            k = max(1, int(np.ceil(attack.frac * rows.size)))
            rows = np.sort(rng.choice(rows, size=k, replace=False))
        d = self._direction(client, src.shape[1], attack.kind)
        idx = torch.as_tensor(rows, device=src.device)
        sel = src[idx].detach().cpu().numpy().astype(np.float32, copy=False)
        norms = np.linalg.norm(sel, axis=1, keepdims=True)
        target = norms * d[None, :]
        new = (1.0 - attack.strength) * sel + attack.strength * target
        # norm-evading cap: just under the receiver's screen bound
        cap = attack.evade * self.plan.bound
        nn = np.linalg.norm(new, axis=1, keepdims=True)
        new = new * np.minimum(1.0, cap / np.maximum(nn, 1e-12))
        ent = src.clone()
        ent[idx] = torch.from_numpy(new.astype(np.float32)).to(src.device)
        out = dict(view)
        out["ent"] = ent
        return out

    # -------------------------------------------------- checkpoint surface
    def stale_arrays(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The replay cache as a checkpointable tree:
        ``{"client::host": {leaf: array}}`` (see ``save_scheduler``)."""
        return {f"{c}::{h}": dict(v) for (c, h), v in sorted(self._stale.items())}

    def load_stale(self, tree: Dict[str, Dict]) -> None:
        self._stale = {
            tuple(key.split("::", 1)): {
                k: np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a, np.float32)
                for k, a in leaves.items()
            }
            for key, leaves in tree.items()
        }


def resolve_adversary(src) -> Optional[Adversary]:
    """Normalize a resolved ``tick_adversary`` source (spec string /
    ``AdversaryPlan`` / ``Adversary``) to an :class:`Adversary`."""
    if src is None:
        return None
    if isinstance(src, Adversary):
        return src
    plan = src if isinstance(src, AdversaryPlan) else AdversaryPlan.parse(src)
    return Adversary(plan)
