"""Seeded chaos for the serving query path: the serving subset of the JAX
package's ``core/faults.py``, kept as its own numpy copy.

Every draw is a pure function of ``(seed, batch, replica)`` through
``np.random.default_rng``, so the same plan injects the same faults as the
JAX package's ``ServeFaultPlan`` and replays byte-identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

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
