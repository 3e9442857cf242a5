"""Faults that more than one cell plants: the epoch step, which training,
the initial training and every handshake's retrain run."""
from __future__ import annotations

import torch


def _unchanged_step(monkeypatch):
    """Every epoch step returns the tables as they were."""
    from repro_torch.kge import engine

    for impl in list(engine._EPOCHS):
        monkeypatch.setitem(engine._EPOCHS, impl,
                            lambda params, spec, pos, neg, lr: torch.zeros(pos.shape[0]))


def _half_batch(monkeypatch):
    """Every step leaves out half of its batch and means over the rest."""
    from repro_torch.kge import engine

    for impl, real in list(engine._EPOCHS.items()):
        def half(params, spec, pos, neg, lr, real=real):
            b = max(1, pos.shape[1] // 2)
            return real(params, spec, pos[:, :b].contiguous(), neg[:, :b].contiguous(), lr)

        monkeypatch.setitem(engine._EPOCHS, impl, half)
