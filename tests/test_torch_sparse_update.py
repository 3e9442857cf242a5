"""Port parity: the fused sparse SGD step (``repro_torch.kernels.sparse_update``,
its plain version on CPU tensors) against the JAX package's
``fused_sparse_step`` run as its own tests run it on the CPU (Pallas in
interpret mode) and against the dense autograd oracles of both packages.

Batches are built to break a wrong step: a hub entity in many occurrences,
row 0 and row E−1, and pos and neg sharing rows. On dyadic tables with
B = 8 and lr = 0.5 every value of an l1 or dot step is exact in fp32, so
tables and loss must be bit-equal; l2 (a sqrt and a division) is held
within atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import dyadic

from repro.kernels.sparse_update import fused_sparse_step as jax_fused_step
from repro.kernels.sparse_update import sparse_step_ref as jax_step_ref
from repro_torch.kernels.sparse_update import (
    LAUNCHES,
    fused_sparse_step,
    sparse_step_plain,
    sparse_step_ref,
)

E, R, D, B = 48, 5, 16, 8


def hard_batch(rng, e, r, b):
    """(pos, neg) int64 (b, 3): a hub entity in most occurrences, ids 0 and
    e−1 present, and rows shared between pos and neg."""
    pos = np.stack([rng.integers(0, e, b), rng.integers(0, r, b), rng.integers(0, e, b)], 1)
    neg = pos.copy()
    side = rng.random(b) < 0.5
    rand = rng.integers(0, e, b)
    neg[side, 0] = rand[side]
    neg[~side, 2] = rand[~side]
    hub = e // 2
    pos[: b // 2, 0] = hub
    neg[: b // 3, 2] = hub
    pos[b - 1, 2] = hub
    pos[1, 2] = 0
    neg[2, 0] = e - 1
    neg[3, 0] = pos[4, 2]  # a neg head that is a pos tail
    pos[5, 1] = neg[6, 1] = r - 1
    return pos.astype(np.int64), neg.astype(np.int64)


def _tables(seed, e=E, r=R, d=D, *, dy=True):
    rng = np.random.default_rng(seed)
    if dy:
        return dyadic(rng, (e, d)), dyadic(rng, (r, d)), rng
    return (rng.normal(0, 0.3, (e, d)).astype(np.float32),
            rng.normal(0, 0.3, (r, d)).astype(np.float32), rng)


def _jax(ent, rel, pos, neg, lr, mode, margin):
    je, jr, jl = jax_fused_step(jnp.asarray(ent), jnp.asarray(rel), jnp.asarray(pos, jnp.int32),
                                jnp.asarray(neg, jnp.int32), lr, mode=mode, margin=margin,
                                interpret=True)
    return np.asarray(je), np.asarray(jr), np.float32(jl)


def _port(ent, rel, pos, neg, lr, mode, margin):
    te, tr = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    oe, orl, loss = fused_sparse_step(te, tr, torch.from_numpy(pos), torch.from_numpy(neg), lr,
                                      mode=mode, margin=margin)
    assert oe is te and orl is tr  # updated in place
    return te.numpy(), tr.numpy(), np.float32(loss)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_plain_step_matches_jax_pallas_on_dyadic(mode, seed):
    ent, rel, rng = _tables(seed)
    pos, neg = hard_batch(rng, E, R, B)
    want = _jax(ent, rel, pos, neg, 0.5, mode, 4.0)
    got = _port(ent, rel, pos, neg, 0.5, mode, 4.0)
    if mode == "l2":
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    else:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the step moved the hub row, and left rows the batch never named alone
    touched = set(pos[:, [0, 2]].ravel()) | set(neg[:, [0, 2]].ravel())
    untouched = sorted(set(range(E)) - touched)
    np.testing.assert_array_equal(got[0][untouched], ent[untouched])
    assert not np.array_equal(got[0][E // 2], ent[E // 2])


@pytest.mark.parametrize("mode,margin", [("l1", 4.0), ("l2", 2.0), ("dot", 2.0)])
def test_plain_step_matches_dense_oracles_on_continuous_tables(mode, margin):
    ent, rel, rng = _tables(7, dy=False)
    pos, neg = hard_batch(rng, E, R, 10)
    got = _port(ent, rel, pos, neg, 0.1, mode, margin)
    je, jr, jl = jax_step_ref(jnp.asarray(ent), jnp.asarray(rel), jnp.asarray(pos, jnp.int32),
                              jnp.asarray(neg, jnp.int32), 0.1, mode=mode, margin=margin)
    te, tr, tl = sparse_step_ref(torch.from_numpy(ent), torch.from_numpy(rel),
                                 torch.from_numpy(pos), torch.from_numpy(neg), 0.1,
                                 mode=mode, margin=margin)
    for want in ((np.asarray(je), np.asarray(jr), float(jl)),
                 (te.numpy(), tr.numpy(), float(tl))):
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)


@pytest.mark.parametrize("mode,atol", [("l1", 0.0), ("dot", 1e-6)])
def test_plain_trajectory_matches_jax_over_steps(mode, atol):
    """Eight consecutive steps on the same dyadic start, a new hard batch
    each. l1 steps move rows by multiples of 1/16, so the tables stay exact
    and bit-equal step after step; after the first dot step the products
    are no longer exact, so dot is held within atol 1e-6."""
    ent, rel, rng = _tables(3)
    je, jr = ent, rel
    te, tr = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    for _ in range(8):
        pos, neg = hard_batch(rng, E, R, B)
        je, jr, jl = _jax(je, jr, pos, neg, 0.5, mode, 4.0)
        _, _, tl = fused_sparse_step(te, tr, torch.from_numpy(pos), torch.from_numpy(neg), 0.5,
                                     mode=mode, margin=4.0)
        np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=atol)
        np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=atol)
        np.testing.assert_allclose(np.float32(tl), jl, rtol=1e-6 if atol else 0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ent, rel, rng = _tables(4)
    pos, neg = hard_batch(rng, E, R, B)
    before = dict(LAUNCHES)
    a = [torch.from_numpy(x.copy()) for x in (ent, rel)]
    b = [torch.from_numpy(x.copy()) for x in (ent, rel)]
    loss = fused_sparse_step(*a, torch.from_numpy(pos), torch.from_numpy(neg), 0.5)[2]
    plain = sparse_step_plain(*b, torch.from_numpy(pos), torch.from_numpy(neg), 0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and torch.equal(loss, plain)
    assert LAUNCHES == before


def test_wrapper_rejects_what_the_step_does_not_take():
    ent, rel = torch.zeros(E, D), torch.zeros(R, D)
    pos = torch.zeros(B, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown sparse mode"):
        fused_sparse_step(ent, rel, pos, pos, 0.5, mode="cl1")
    with pytest.raises(ValueError, match=r"\(E, d\)"):
        fused_sparse_step(ent, torch.zeros(R, D + 1), pos, pos, 0.5)
    with pytest.raises(ValueError, match=r"\(B, 3\)"):
        fused_sparse_step(ent, rel, pos[:, :2], pos[:, :2], 0.5)
    with pytest.raises(ValueError, match=r"B >= 1"):
        fused_sparse_step(ent, rel, pos[:0], pos[:0], 0.5)
