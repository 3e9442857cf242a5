"""``fed.yago-dbpedia.handshake-ticks``: the epoch step's faults, which the
initial training and every retrain run, and two of the handshake's own."""
import torch

from chipbench.cells._shared import _half_batch, _unchanged_step


def _unrefined(monkeypatch):
    """The handshake's synthesized rows leave the Procrustes refine out."""
    from repro_torch.core import tick_engine

    monkeypatch.setattr(tick_engine, "procrustes", lambda a, b: torch.eye(
        a.shape[1], dtype=a.dtype, device=a.device))


def _zeroed_retrain(monkeypatch):
    """Each handshake's retrain hands back zeroed entity rows, which score
    no better than chance, so the backtrack restores every host: a fault
    that hides behind a restore."""
    from repro_torch.core import tick_engine

    real = tick_engine._STAGES["strip"]

    def zeroed(s, spec):
        return {k: v * 0 if k == "out/ent" else v for k, v in real(s, spec).items()}

    monkeypatch.setitem(tick_engine._STAGES, "strip", zeroed)


FAULTS = [_unchanged_step, _half_batch, _unrefined, _zeroed_retrain]
CONTROLS = ["half_batch", "unchanged_retrain"]
SPAN_METRICS = ["tick.host_ms", "tick.sync_wait_ms"]
