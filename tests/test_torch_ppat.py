"""Port parity: ``repro_torch.core.ppat`` against the JAX package's PPAT.

Both packages start from the same discriminators (the JAX init carried
across with ``host_params_from_numpy``) and take the same draws (the JAX
key's batch ids and Laplace noise, ``_torch_parity.jax_ppat_draws``).

* One host step: new params, ∂L_G/∂adv and metrics within rtol 1e-5 /
  atol 1e-6 (the frameworks sum in different orders).
* A 12-round fused handshake: the clean vote counts n0/n1 equal in every
  round, ε bit-equal (the accountant is float64 numpy fed the same counts),
  W within 1e-5. Votes are a threshold at 0.5, so a one-ulp difference in a
  probability next to 0.5 could flip one; over a short run none is that
  close, and longer runs are not compared vote for vote.
* The stepwise loop samples from the same numpy streams as the JAX one:
  with the JAX per-round noise it gives the same ε; only (B, d) tensors
  cross the boundary.
* ``leaky_relu`` at exactly 0 differentiates as in JAX (slope 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from _torch_parity import jax_ppat_draws, jax_ppat_init, jax_stepwise_noise

from repro.core import ppat as jp
from repro.core.alignment import procrustes as jax_procrustes
from repro_torch.core import alignment as ta
from repro_torch.core import ppat as tp

D, N, HIDDEN, STEPS = 16, 100, 16, 12


def _cfgs(**kw):
    kw = {"hidden": HIDDEN, "steps": STEPS, **kw}
    return jp.PPATConfig(**kw), tp.PPATConfig(**kw)


@pytest.fixture(scope="module")
def pair():
    """A client set and a host set that is its rotation plus noise."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(D, D)))
    y = (x @ q + 0.01 * rng.normal(size=(N, D))).astype(np.float32)
    return x, y


def _host_inputs(seed, cfg, d=D):
    """Host params with random (nonzero) velocities, as numpy."""
    hp = jax.tree.map(np.array, jp._init_host_params(jax.random.PRNGKey(seed), d, cfg))
    rng = np.random.default_rng(seed)
    for k in ("teachers_vel", "student_vel"):
        hp[k] = {n: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
                 for n, v in hp[k].items()}
    return hp


def _assert_tree(got, want, rtol=1e-5, atol=1e-6):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree(got[k], v, rtol, atol)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=k)


def _host_step_both(hp, adv, real, cfg_j, cfg_t, key):
    jparams, jgrad, jmetrics, (jn0, jn1) = jp._host_step_impl(
        hp, key, jnp.asarray(adv), jnp.asarray(real), cfg_j)
    noise = torch.as_tensor(np.array(jax.random.laplace(key, (2, len(adv)))))
    tparams, tgrad, tmetrics, (tn0, tn1) = tp._host_step_impl(
        tp.host_params_from_numpy(hp, "cpu"), noise, torch.as_tensor(adv),
        torch.as_tensor(real), cfg_t)
    return (jparams, jgrad, jmetrics, jn0, jn1), (tparams, tgrad, tmetrics, tn0, tn1)


@pytest.mark.parametrize("saturating", [False, True])
def test_one_host_step_matches(pair, saturating):
    x, y = pair
    cfg_j, cfg_t = _cfgs(saturating=saturating)
    hp = _host_inputs(1, cfg_j)
    rng = np.random.default_rng(2)
    adv = x[rng.integers(0, N, cfg_j.batch)] @ np.eye(D, dtype=np.float32)
    real = y[rng.integers(0, N, cfg_j.batch)]
    (jparams, jgrad, jm, jn0, jn1), (tparams, tgrad, tm, tn0, tn1) = _host_step_both(
        hp, adv, real, cfg_j, cfg_t, jax.random.PRNGKey(3))
    _assert_tree(tparams, jparams)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    assert np.array_equal(tn0.numpy(), np.asarray(jn0))
    assert np.array_equal(tn1.numpy(), np.asarray(jn1))


def test_leaky_relu_at_zero_follows_jax(pair, monkeypatch):
    """A sample that is exactly 0 meets the zero biases of a fresh
    discriminator with an exactly zero pre-activation: its ∂L_G/∂adv row is
    w1·diag(leaky'(0))·w2-shaped, so the slope at 0 shows in it."""
    x, y = pair
    cfg_j, cfg_t = _cfgs()
    hp = jax.tree.map(np.array, jp._init_host_params(jax.random.PRNGKey(4), D, cfg_j))
    adv = x[: cfg_j.batch].copy()
    adv[5] = 0.0
    real = y[: cfg_j.batch]
    (_, jgrad, _, _, _), (_, tgrad, _, _, _) = _host_step_both(
        hp, adv, real, cfg_j, cfg_t, jax.random.PRNGKey(5))
    assert float(np.abs(np.asarray(jgrad)[5]).max()) > 1e-4
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
    # PyTorch's own leaky_relu (slope 0.2 at 0) would move that row
    monkeypatch.setattr(tp, "_leaky_relu", lambda v: F.leaky_relu(v, 0.2))
    _, (_, other, _, _, _) = _host_step_both(hp, adv, real, cfg_j, cfg_t,
                                             jax.random.PRNGKey(5))
    assert float(np.abs(other.numpy()[5] - np.asarray(jgrad)[5]).max()) > 1e-5
    np.testing.assert_allclose(np.delete(other.numpy(), 5, 0), np.delete(np.asarray(jgrad), 5, 0),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"ortho_beta": 0.0, "lam": 0.5}])
def test_fused_handshake_matches_on_the_jax_draws(pair, kw):
    x, y = pair
    cfg_j, cfg_t = _cfgs(**kw)
    key = jax.random.PRNGKey(11)
    xp, yp = jp._pad_rows(jnp.asarray(x), jp.PPAT_BUCKET), jp._pad_rows(jnp.asarray(y),
                                                                         jp.PPAT_BUCKET)
    _, jw, jmetrics, jn0, jn1 = jp._ppat_entry(xp, yp, jnp.int32(N), jnp.int32(N), key, cfg_j)
    init = tp.host_params_from_numpy(jax_ppat_init(key, D, cfg_j), "cpu")
    draws = tp.PPATDraws(*(torch.as_tensor(a) for a in jax_ppat_draws(key, cfg_j, N, N)))
    assert tuple(draws.idx.shape) == (STEPS, cfg_t.batch)
    _, tw, tmetrics, tn0, tn1 = tp.ppat_entry_graph(
        tp._pad_rows(torch.as_tensor(x), tp.PPAT_BUCKET),
        tp._pad_rows(torch.as_tensor(y), tp.PPAT_BUCKET), N, N, cfg_t, init=init, draws=draws)
    assert np.array_equal(tn0.numpy(), np.asarray(jn0))
    assert np.array_equal(tn1.numpy(), np.asarray(jn1))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(tmetrics[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # the same through train_ppat: ε bit-equal, W and the history as above
    jc, jh, jhist = jp.train_ppat(jnp.asarray(x), jnp.asarray(y), cfg_j, key=key)
    tc, th, thist = tp.train_ppat(torch.as_tensor(x), torch.as_tensor(y), cfg_t, init=init,
                                  draws=draws)
    assert thist["epsilon"] == jhist["epsilon"] and thist["max_alpha"] == jhist["max_alpha"]
    assert th.accountant.queries == STEPS * cfg_t.batch
    np.testing.assert_allclose(tc.w.numpy(), np.asarray(jc.w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(thist["gen_loss"], jhist["gen_loss"], rtol=1e-4, atol=1e-5)


def test_stepwise_loop_boundary_and_parity(pair):
    x, y = pair
    cfg_j, cfg_t = _cfgs()
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    host = tp.PPATHost(torch.Generator().manual_seed(0), D, yt, cfg_t)
    client = tp.PPATClient(D, xt, cfg_t)
    xb, adv = client.sample_batch()
    assert tuple(adv.shape) == (cfg_t.batch, D)           # client → host: adv only
    grad, metrics = host.step(adv)
    assert tuple(grad.shape) == tuple(adv.shape)          # host → client: grads only
    assert set(metrics) >= {"gen_loss", "student_loss", "teacher_loss", "vote_mean"}
    client.apply_grad(xb, grad)
    assert host.accountant.queries == cfg_t.batch
    # the whole stepwise handshake against the JAX one: same numpy batch
    # streams, the JAX noise per round, the JAX init
    key = jax.random.PRNGKey(12)
    jc, _, jhist = jp.train_ppat(jnp.asarray(x), jnp.asarray(y), cfg_j, key=key, fused=False)
    kh, _ = jax.random.split(key)
    init = tp.host_params_from_numpy(
        jax.tree.map(np.asarray, jp._init_host_params(kh, D, cfg_j)), "cpu")
    noise = torch.as_tensor(jax_stepwise_noise(key, cfg_j))
    tc, _, thist = tp.train_ppat(xt, yt, cfg_t, init=init, fused=False,
                                 draws=tp.PPATDraws(None, None, noise))
    assert thist["epsilon"] == jhist["epsilon"]
    np.testing.assert_allclose(tc.w.numpy(), np.asarray(jc.w), rtol=0, atol=1e-5)


def test_own_draws_are_seeded_and_refinement_recovers_rotation(pair):
    """The port's own draws (a generator seeded ``cfg.seed``): a handshake
    is reproducible, W moves, ε is finite, and host-local procrustes makes
    the release usable (the JAX package's test_ppat_plus_refinement)."""
    x, y = pair
    _, cfg = _cfgs(steps=120)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    c1, _, h1 = tp.train_ppat(xt, yt, cfg)
    c2, _, h2 = tp.train_ppat(x, y, cfg, device="cpu")
    assert torch.equal(c1.w, c2.w) and h1["epsilon"] == h2["epsilon"]
    assert float((c1.w - torch.eye(D)).abs().sum()) > 1e-3
    assert np.isfinite(h1["epsilon"]) and h1["epsilon"] > 0
    synth = c1.generate(xt)
    r = ta.procrustes(synth, yt)
    np.testing.assert_allclose(r.numpy(), np.asarray(jax_procrustes(jnp.asarray(synth.numpy()),
                                                                    jnp.asarray(y))),
                               rtol=0, atol=1e-5)
    assert ta.csls_retrieval_acc(synth @ r, yt) > 0.5
    with pytest.raises(ValueError, match="non-empty"):
        tp.train_ppat(xt[:0], yt, cfg)


def test_padding_rows_stay_zero_through_generate(pair):
    x, _ = pair
    _, cfg = _cfgs()
    c, _, _ = tp.train_ppat(torch.as_tensor(x), torch.as_tensor(x), cfg)
    padded = tp._pad_rows(torch.as_tensor(x), tp.PPAT_BUCKET)
    assert padded.shape[0] == 128 and not bool(padded[N:].any())
    synth = c.generate(padded)
    assert not bool(synth[N:].any())
    np.testing.assert_array_equal(synth[:N].numpy(), c.generate(torch.as_tensor(x)).numpy())


def test_scan_continues_from_a_carried_state(pair):
    """``ppat_scan_graph`` from a mid-handshake state carried across with
    ``ppat_state_from_numpy`` (discriminators with momentum, a W away from
    the identity and its velocity) against the JAX scan on the same key."""
    x, y = pair
    cfg_j, cfg_t = _cfgs()
    hp = _host_inputs(13, cfg_j)
    rng = np.random.default_rng(13)
    w = (np.eye(D) + 0.05 * rng.normal(size=(D, D))).astype(np.float32)
    vel = (0.01 * rng.normal(size=(D, D))).astype(np.float32)
    key = jax.random.PRNGKey(14)
    jhp, jw, jvel, _, jn0, jn1 = jp._ppat_scan(
        hp, jnp.asarray(w), jnp.asarray(vel), jnp.asarray(x), jnp.asarray(y),
        jnp.int32(N), jnp.int32(N), jax.random.split(key)[1], cfg_j)
    draws = tp.PPATDraws(*(torch.as_tensor(a) for a in jax_ppat_draws(key, cfg_j, N, N)))
    thp, tw, tvel, _, tn0, tn1 = tp.ppat_scan_graph(
        *tp.ppat_state_from_numpy(hp, w, vel, "cpu"), torch.as_tensor(x), torch.as_tensor(y),
        N, N, cfg_t, draws=draws)
    assert np.array_equal(tn0.numpy(), np.asarray(jn0))
    assert np.array_equal(tn1.numpy(), np.asarray(jn1))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), rtol=0, atol=1e-5)
    _assert_tree(thp, jhp, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="draws"):
        tp.ppat_scan_graph(thp, tw, tvel, torch.as_tensor(x), torch.as_tensor(y), N, N, cfg_t,
                           draws=tp.PPATDraws(draws.idx[:3], draws.ridx, draws.noise))
