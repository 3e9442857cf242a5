"""PATE mechanism — Eqs. (5)–(6) of the paper.

Teacher discriminators vote {0,1} per sample; i.i.d. Laplace noise of scale
1/λ is added to each class's vote count and the noisy argmax becomes the
student's label. The teachers are one stacked tensor, so the votes are a
``(T, B)`` tensor.

The Laplace draws are an explicit input (the randomness seam): ``torch``
cannot reproduce ``jax.random``, so the tests hand both packages the same
standard-Laplace draws. ``laplace_noise`` is the port's own source.
"""
from __future__ import annotations

from typing import Tuple

import torch


def laplace_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Laplace(0, 1) draws of ``shape`` on the generator's device:
    the difference of two unit exponentials, ``−log(1−r)`` with ``r`` in
    [0, 1), so every draw is finite. (``torch.distributions.Laplace`` takes
    no generator.)"""
    r = torch.rand((2, *shape), generator=generator, device=generator.device)
    return torch.log1p(-r[1]) - torch.log1p(-r[0])


def teacher_votes(probs: torch.Tensor) -> torch.Tensor:
    """probs: (T, B) teacher sigmoid outputs → hard votes (T, B) in {0,1}."""
    return (probs >= 0.5).to(torch.int32)


def pate_vote(noise: torch.Tensor, votes: torch.Tensor, lam: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noisy-argmax aggregation (Eq. 5).

    ``noise``: (2, B) standard Laplace draws; votes: (T, B) hard {0,1} votes
    → (labels (B,) float32, n0 (B,) int32, n1 (B,) int32). ``n0``/``n1``
    are the *clean* counts — the accountant (Eq. 10) consumes them; only the
    released labels carry the noise, scaled by 1/λ as in PATE's Theorems
    2–3 (λ = 0 disables it, with no DP guarantee), as the JAX package does.
    """
    t, b = votes.shape
    if tuple(noise.shape) != (2, b):
        raise ValueError(f"pate_vote: noise must be (2, {b}), got {tuple(noise.shape)}")
    n1 = votes.sum(0, dtype=torch.int32)
    n0 = t - n1
    scale = 0.0 if lam <= 0 else 1.0 / lam
    noise = noise.to(torch.float32) * scale
    noisy0 = n0.to(torch.float32) + noise[0]
    noisy1 = n1.to(torch.float32) + noise[1]
    labels = (noisy1 > noisy0).to(torch.float32)
    return labels, n0, n1
