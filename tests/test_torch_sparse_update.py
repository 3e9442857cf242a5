"""Port parity: the fused sparse SGD step (``repro_torch.kernels.sparse_update``,
its plain version on CPU tensors) against the JAX package's
``fused_sparse_step`` run as its own tests run it on the CPU (Pallas in
interpret mode) and against the dense autograd oracles of both packages.

Batches are built to break a wrong step: a hub entity in many occurrences,
row 0 and row E−1, and pos and neg sharing rows. On dyadic tables with
B = 8 and lr = 0.5 every value of an l1 or dot step is exact in fp32, so
tables and loss must be bit-equal; l2 (a sqrt and a division) is held
within atol 1e-6.

``fused_sparse_epoch`` (a whole epoch of steps; on the card one launch) is
held against the JAX step applied step by step on a 12-row table, where
every step re-reads rows the previous one wrote: l1 steps on dyadic tables
move rows by multiples of 1/16, so tables and every step's loss stay
bit-equal; l2 and dot leave the dyadic grid after a step (a sqrt, products
of updated rows), and the JAX kernel sums each row's gradients by a one-hot
matmul whose order is not the occurrence order, so those are held within
1e-6 on dyadic tables and 1e-5 on continuous ones.
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
    STEPS,
    fused_sparse_epoch,
    fused_sparse_step,
    sparse_epoch_plain,
    sparse_step_plain,
    sparse_step_ref,
)
from repro_torch.kernels.sparse_update.ops import check_batch, smem_bytes

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


# ------------------------------------------------------------------ epochs
def _epoch_batches(rng, e, r, b, nb):
    batches = [hard_batch(rng, e, r, b) for _ in range(nb)]
    return (np.stack([p for p, _ in batches]), np.stack([n for _, n in batches]))


@pytest.mark.parametrize("dy", [True, False], ids=["dyadic", "continuous"])
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_plain_epoch_matches_jax_step_by_step(mode, dy):
    """Twelve steps on a 12-row table (every row recurs from step to step)
    against the JAX package's fused step applied twelve times."""
    e, r, b, nb = 12, 3, 8, 12
    ent, rel, rng = _tables(5, e, r, D, dy=dy)
    pos, neg = _epoch_batches(rng, e, r, b, nb)
    je, jr, jl = ent, rel, []
    for i in range(nb):
        je, jr, li = _jax(je, jr, pos[i], neg[i], 0.5, mode, 4.0)
        jl.append(li)
    te, tr = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    losses = fused_sparse_epoch(te, tr, torch.from_numpy(pos), torch.from_numpy(neg), 0.5,
                                mode=mode, margin=4.0)
    assert losses.shape == (nb,) and losses.dtype == torch.float32
    assert not np.array_equal(te.numpy(), ent)
    if dy and mode == "l1":
        np.testing.assert_array_equal(te.numpy(), je)
        np.testing.assert_array_equal(tr.numpy(), jr)
        np.testing.assert_array_equal(losses.numpy(), np.array(jl, np.float32))
    else:
        atol = 1e-6 if dy else 1e-5
        np.testing.assert_allclose(te.numpy(), je, rtol=0, atol=atol)
        np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=atol)
        np.testing.assert_allclose(losses.numpy(), np.array(jl, np.float32), rtol=atol,
                                   atol=atol)


@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_epoch_equals_its_steps_and_one_step_is_the_step(mode):
    """An epoch equals the plain step applied step by step, bit for bit, and
    an epoch of one batch equals ``fused_sparse_step`` on it."""
    e, r, b, nb = 16, 4, 10, 9
    ent, rel, rng = _tables(9, e, r, D, dy=False)
    pos, neg = (torch.from_numpy(x) for x in _epoch_batches(rng, e, r, b, nb))
    ke, kr = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    pe, pr = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    kl = fused_sparse_epoch(ke, kr, pos, neg, 0.3, mode=mode, margin=2.0)
    pl = torch.stack([sparse_step_plain(pe, pr, pos[i], neg[i], 0.3, mode=mode, margin=2.0)
                      for i in range(nb)])
    assert torch.equal(ke, pe) and torch.equal(kr, pr) and torch.equal(kl, pl)
    pe2, pr2 = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    assert torch.equal(sparse_epoch_plain(pe2, pr2, pos, neg, 0.3, mode=mode, margin=2.0), pl)
    one_e, one_r = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    st_e, st_r = torch.from_numpy(ent.copy()), torch.from_numpy(rel.copy())
    l1 = fused_sparse_epoch(one_e, one_r, pos[:1], neg[:1], 0.3, mode=mode, margin=2.0)
    ls = fused_sparse_step(st_e, st_r, pos[0], neg[0], 0.3, mode=mode, margin=2.0)[2]
    assert l1.shape == (1,) and ls.shape == ()
    assert torch.equal(one_e, st_e) and torch.equal(one_r, st_r) and torch.equal(l1[0], ls)


def test_cpu_epoch_counts_no_launch_and_no_step():
    ent, rel, rng = _tables(4)
    pos, neg = (torch.from_numpy(x) for x in _epoch_batches(rng, E, R, B, 3))
    before = dict(LAUNCHES), dict(STEPS)
    fused_sparse_epoch(torch.from_numpy(ent), torch.from_numpy(rel), pos, neg, 0.5)
    assert (dict(LAUNCHES), dict(STEPS)) == before


def test_epoch_wrapper_rejects_what_the_kernel_does_not_take():
    ent, rel = torch.zeros(E, D), torch.zeros(R, D)
    pos = torch.zeros(2, B, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="unknown sparse mode"):
        fused_sparse_epoch(ent, rel, pos, pos, 0.5, mode="cl1")
    with pytest.raises(ValueError, match=r"\(nb, B, 3\)"):
        fused_sparse_epoch(ent, rel, pos[0], pos[0], 0.5)
    with pytest.raises(ValueError, match=r"\(nb, B, 3\)"):
        fused_sparse_epoch(ent, rel, pos[:0], pos[:0], 0.5)
    with pytest.raises(ValueError, match=r"\(nb, B, 3\)"):
        fused_sparse_epoch(ent, rel, pos, pos[:1], 0.5)
    with pytest.raises(ValueError, match=r"\(E, d\)"):
        fused_sparse_epoch(ent, torch.zeros(R, D + 1), pos, pos, 0.5)


@pytest.mark.parametrize("d,cap", [(100, 544), (33, 1056), (128, 451)])
def test_batch_cap_of_the_cluster_shared_memory(d, cap):
    """The kernel's shared memory per block (``smem_bytes``, mirrored in the
    CUDA source): the gradient rows of a batch of up to ``cap`` rows fit the
    cluster's shared memory, and one more row raises."""
    check_batch(1, d)
    check_batch(cap, d)
    assert smem_bytes(cap, d) <= 232_448 < smem_bytes(cap + 1, d)
    with pytest.raises(ValueError, match="shared memory"):
        check_batch(cap + 1, d)
