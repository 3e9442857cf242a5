"""Port parity: ``repro_torch.core.privacy`` and ``repro_torch.core.pate``
against the JAX package's.

The moments accountant is numpy float64 in both packages, so ε and every
α(l) must be bit-equal for the same clean vote counts fed in the same order,
also through ``merge`` and a ``state_dict`` round trip. PATE labels must be
equal when both mechanisms get the same Laplace draws (the JAX package's
``jax.random.laplace`` of the vote key, handed to the port as an input).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pate as jpate
from repro.core import ppat as jppat
from repro.core.privacy import MomentsAccountant as JaxAccountant
from repro_torch.core import pate as tpate
from repro_torch.core import ppat as tppat
from repro_torch.core.privacy import MomentsAccountant


def _counts(seed, shape, t=4):
    rng = np.random.default_rng(seed)
    n1 = rng.integers(0, t + 1, shape).astype(np.int32)
    return (t - n1).astype(np.int32), n1


@pytest.mark.parametrize("lam", [0.05, 0.5, 1.0, 0.0])
@pytest.mark.parametrize("shape", [(200, 32), (7, 3), (1,)])
def test_accountant_bit_equal(lam, shape):
    n0, n1 = _counts(int(lam * 100) + len(shape), shape)
    ja, ta = JaxAccountant(lam, 1e-5), MomentsAccountant(lam, 1e-5)
    ja.update(n0.ravel(), n1.ravel())
    ta.update(n0.ravel(), n1.ravel())
    assert np.array_equal(ta.alpha, ja.alpha)
    assert ta.epsilon() == ja.epsilon()
    assert ta.max_alpha() == ja.max_alpha()
    assert ta.best_moment() == ja.best_moment()
    assert ta.queries == ja.queries == n0.size


def test_accountant_merge_and_state_dict_round_trip():
    ja, ta = JaxAccountant(0.05, 1e-5), MomentsAccountant(0.05, 1e-5)
    for seed in range(3):
        n0, n1 = _counts(seed, (12, 32))
        jh, th = JaxAccountant(0.05, 1e-5), MomentsAccountant(0.05, 1e-5)
        jh.update(n0.ravel(), n1.ravel())
        th.update(n0.ravel(), n1.ravel())
        ja.merge(jh)
        ta.merge(th)
    assert np.array_equal(ta.alpha, ja.alpha) and ta.epsilon() == ja.epsilon()
    state = json.loads(json.dumps(ta.state_dict()))
    assert state == json.loads(json.dumps(ja.state_dict()))
    restored = MomentsAccountant(0.05, 1e-5)
    restored.load_state_dict(state)
    assert restored.epsilon() == ta.epsilon() and restored.queries == ta.queries
    with pytest.raises(ValueError):
        ta.merge(MomentsAccountant(0.5, 1e-5))
    with pytest.raises(ValueError):
        MomentsAccountant(0.5, 1e-5).load_state_dict(state)


@pytest.mark.parametrize("lam", [0.05, 1.0, 0.0])
@pytest.mark.parametrize("t,b", [(4, 32), (5, 17)])
def test_pate_vote_equal_with_injected_noise(lam, t, b):
    rng = np.random.default_rng(t * b)
    probs = rng.random((t, b)).astype(np.float32)
    probs[0, :3] = 0.5  # the vote threshold itself counts as a 1
    key = jax.random.PRNGKey(t + b)
    jv = jpate.teacher_votes(jnp.asarray(probs))
    jl, jn0, jn1 = jpate.pate_vote(key, jv, lam)
    noise = np.array(jax.random.laplace(key, (2, b)))
    tv = tpate.teacher_votes(torch.as_tensor(probs))
    tl, tn0, tn1 = tpate.pate_vote(torch.as_tensor(noise), tv, lam)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert np.array_equal(tn0.numpy(), np.asarray(jn0))
    assert np.array_equal(tn1.numpy(), np.asarray(jn1))
    with pytest.raises(ValueError, match="noise"):
        tpate.pate_vote(torch.zeros(2, b + 1), tv, lam)


def test_laplace_noise_is_standard_laplace_and_seeded():
    g = torch.Generator().manual_seed(0)
    x = tpate.laplace_noise(g, (200_000,))
    assert bool(torch.isfinite(x).all())
    assert abs(float(x.mean())) < 0.02
    assert abs(float(x.var()) - 2.0) < 0.05          # Var Laplace(0, 1) = 2
    assert abs(float(x.abs().mean()) - 1.0) < 0.01   # E|X| = 1
    again = tpate.laplace_noise(torch.Generator().manual_seed(0), (200_000,))
    assert torch.equal(x, again)


def test_noisy_vote_labels_equal_with_injected_noise():
    cfg = jppat.PPATConfig(hidden=16)
    d, n, rounds = 8, 40, 5
    key = jax.random.PRNGKey(7)
    hp = jax.tree.map(np.asarray, jppat._init_host_params(key, d, cfg))
    rows = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    vkey = jax.random.PRNGKey(8)
    want = jppat.noisy_vote_labels(hp, jnp.asarray(rows), 0.5, vkey, rounds=rounds)
    noise = np.stack([np.asarray(jax.random.laplace(k, (2, n)))
                      for k in jax.random.split(vkey, rounds)])
    got = tppat.noisy_vote_labels(tppat.host_params_from_numpy(hp, "cpu"),
                                  torch.as_tensor(rows), 0.5, noise=torch.as_tensor(noise),
                                  rounds=rounds)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    g = torch.Generator().manual_seed(3)
    own = tppat.noisy_vote_labels(tppat.host_params_from_numpy(hp, "cpu"),
                                  torch.as_tensor(rows), 0.5, generator=g, rounds=rounds)
    assert own.shape == (n,) and ((own >= 0) & (own <= 1)).all()
