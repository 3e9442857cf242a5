"""Materializing oracles for the SSD kernel (tests only): the whole SSD over
a sequence and one chunk of it, in the (B, S, H, P) layout, delegating to
the plain ``ssd``/``ssd_chunk`` of ``models/ssm.py`` as the JAX package's
``ssd_scan/ref.py`` does."""
from __future__ import annotations


def ssd_chunk_ref(x, dt, a, bm, cm, state):
    from repro_torch.models.ssm import ssd_chunk

    return ssd_chunk(x, dt, a, bm, cm, state)


def ssd_ref(x, dt, a, bm, cm, chunk, state=None):
    from repro_torch.models.ssm import ssd

    return ssd(x, dt, a, bm, cm, chunk, state)
