"""Moments accountant for the PPAT network — Eqs. (8)–(10), Alg. 2 ll. 18–20.

The JAX package's ``core/privacy.py``, kept as its own copy: it is numpy
float64 throughout, so the same clean vote counts in the same order give a
bit-equal ε.

Tracks α(l) for a range of moments l; each PATE query (one noisy vote batch)
adds the per-query moment bound

    α(l) += min{ 2λ²l(l+1),
                 log((1−q)·((1−q)/(1−e^{2λ}q))^l + q·e^{2λl}) }        (Eq. 9)
    q    = (2 + λ|n0−n1|) / (4·exp(λ|n0−n1|))                          (Eq. 10)

and the privacy estimate is ε̂ = min_l (α(l) + log(1/δ)) / l (Eq. 8). The
data-dependent log-term is only a valid bound when q < 1/(1+e^{2λ}) (PATE
Thms. 2–3); outside that regime we fall back to the data-independent
2λ²l(l+1) term, which the ``min`` does automatically once the log-term is
guarded against producing NaN/negative values.
"""
from __future__ import annotations

import numpy as np


class MomentsAccountant:
    def __init__(self, lam: float, delta: float, max_moment: int = 32):
        self.lam = float(lam)
        self.delta = float(delta)
        self.ls = np.arange(1, max_moment + 1, dtype=np.float64)
        self.alpha = np.zeros_like(self.ls)
        self.queries = 0

    def update(self, n0, n1) -> None:
        """Account one PATE query (or a batch: n0/n1 arrays).

        Vectorized over the query batch: one (Q, L) broadcast instead of a
        Python loop — a federation tick accounts steps × batch ≈ 2k queries
        per handshake, and the per-query loop was a measurable host-side
        serial cost in an otherwise device-resident tick. Per-query math is
        Eqs. 9–10 exactly as before; the moment accumulators gain only the
        usual pairwise-vs-sequential float summation reordering (both tick
        engines share this accountant, so their ε parity is unaffected)."""
        n0 = np.atleast_1d(np.asarray(n0, dtype=np.float64)).ravel()
        n1 = np.atleast_1d(np.asarray(n1, dtype=np.float64)).ravel()
        if n0.size == 0:
            return
        lam, ls = self.lam, self.ls
        gap = np.abs(n0 - n1)                                   # (Q,)
        q = (2.0 + lam * gap) / (4.0 * np.exp(lam * gap))       # Eq. 10
        data_indep = 2.0 * lam**2 * ls * (ls + 1.0)             # (L,)
        denom = 1.0 - np.exp(2.0 * lam) * q                     # (Q,)
        ok = (q < 1.0 / (1.0 + np.exp(2.0 * lam))) & (denom > 0)
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            ratio = (1.0 - q) / np.where(ok, denom, 1.0)        # (Q,)
            term = (
                (1.0 - q)[:, None] * ratio[:, None] ** ls[None, :]
                + q[:, None] * np.exp(2.0 * lam * ls)[None, :]
            )                                                   # (Q, L)
            data_dep = np.log(np.maximum(term, 1e-300))
        bound = np.where(
            ok[:, None],
            np.minimum(data_indep[None, :], np.maximum(data_dep, 0.0)),
            data_indep[None, :],
        )
        self.alpha += bound.sum(axis=0)
        self.queries += int(gap.size)

    def merge(self, other: "MomentsAccountant") -> None:
        """Fold another accountant's spend into this one. Moment bounds are
        additive across queries (Eq. 9 accumulates per query), so merging a
        per-handshake accountant into a federation-lifetime one yields the
        composed bound bit-for-bit — the scheduler uses this to keep a
        cumulative ε across every handshake it ever executed."""
        if (self.lam, self.delta) != (other.lam, other.delta) or \
                self.ls.shape != other.ls.shape:
            raise ValueError("cannot merge accountants with different "
                             "(lam, delta, max_moment)")
        self.alpha += other.alpha
        self.queries += other.queries

    def state_dict(self) -> dict:
        """JSON-serializable snapshot for crash-consistent scheduler resume
        (``checkpoint.save_scheduler``). Floats round-trip exactly through
        ``repr`` — the restored accountant reports bit-identical ε."""
        return {
            "lam": self.lam,
            "delta": self.delta,
            "alpha": [float(a) for a in self.alpha],
            "queries": int(self.queries),
        }

    def load_state_dict(self, state: dict) -> None:
        if (float(state["lam"]), float(state["delta"])) != (self.lam, self.delta):
            raise ValueError("checkpointed accountant (lam, delta) mismatch")
        alpha = np.asarray(state["alpha"], dtype=np.float64)
        if alpha.shape != self.alpha.shape:
            raise ValueError("checkpointed accountant moment range mismatch")
        self.alpha = alpha
        self.queries = int(state["queries"])

    def epsilon(self) -> float:
        """ε̂ = min_l (α(l) + log(1/δ)) / l — Eq. 8."""
        return float(np.min((self.alpha + np.log(1.0 / self.delta)) / self.ls))

    def best_moment(self) -> int:
        return int(self.ls[np.argmin((self.alpha + np.log(1.0 / self.delta)) / self.ls)])

    def max_alpha(self) -> float:
        return float(np.max(self.alpha))
