"""Port parity: ``repro_torch.kernels.triple_score`` against the JAX
package's Pallas kernels (run in interpret mode, as its own tests run them on
the CPU) and its ``lax.scan`` twin, on the same numpy inputs.

On the CPU the wrappers take their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions by ``test_torch_cuda.py``,
which runs only where a card is present.

Tolerances: pairwise scores ``atol 1e-4`` (the two frameworks sum in
different orders). Rank counts are exact on dyadic inputs, where every fp32
sum is exact in any order; on continuous inputs and in ``cl1`` they may
differ only by near-ties (entities within ``1e-5·(1+|gold|)`` of gold).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import dyadic, near_tie_ok

from repro.kernels.triple_score import fused_ranks as jax_fused_ranks
from repro.kernels.triple_score import fused_ranks_ref as jax_fused_ranks_ref
from repro.kernels.triple_score import pairwise_scores as jax_pairwise_scores
from repro.kernels.triple_score import pairwise_scores_ref as jax_pairwise_scores_ref
from repro_torch.kernels.triple_score import (
    LAUNCHES,
    fused_ranks,
    fused_ranks_ref,
    pairwise_scores,
    pairwise_scores_plain,
    pairwise_scores_ref,
)
from repro_torch.kernels.triple_score.ops import distinct_filter, exclusion_mask

MODES = ["l1", "l2", "dot", "cl1"]
#: (B, E, d, F): ragged B and E against every block size in play
SHAPES = [(8, 256, 32, 4), (13, 300, 16, 3), (5, 97, 8, 1)]


def _inputs(b, e, d, f, *, exact: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    if exact:
        q, ent = dyadic(rng, (b, d)), dyadic(rng, (e, d))
    else:
        q = rng.standard_normal((b, d)).astype(np.float32)
        ent = rng.standard_normal((e, d)).astype(np.float32)
    gold_idx = np.arange(b) % e
    filt = np.full((b, f), -1, np.int32)
    filt[:, 0] = gold_idx
    if f > 1:
        filt[:, 1] = (gold_idx + 7) % e
    if f > 2:
        filt[::2, 2] = (gold_idx[::2] + 11) % e
    return q, ent, gold_idx, filt


def _gold(q, ent, gold_idx, mode):
    s = np.asarray(jax_pairwise_scores_ref(jnp.asarray(q), jnp.asarray(ent), mode=mode))
    return s[np.arange(len(q)), gold_idx].astype(np.float32), s


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------- pairwise
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,e,d,f", SHAPES)
def test_pairwise_scores_parity_with_pallas(b, e, d, f, mode):
    q, ent, _, _ = _inputs(b, e, d, f, exact=False)
    want = np.asarray(jax_pairwise_scores(jnp.asarray(q), jnp.asarray(ent), mode=mode,
                                          interpret=True))
    got = pairwise_scores(_t(q), _t(ent), mode=mode, block_e=64)
    assert got.shape == (b, e) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        pairwise_scores_ref(_t(q), _t(ent), mode=mode).numpy(),
        np.asarray(jax_pairwise_scores_ref(jnp.asarray(q), jnp.asarray(ent), mode=mode)),
        rtol=0, atol=1e-4,
    )


@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_pairwise_scores_bit_equal_on_dyadic(mode):
    q, ent, _, _ = _inputs(11, 150, 32, 1, exact=True, seed=3)
    want = np.asarray(jax_pairwise_scores(jnp.asarray(q), jnp.asarray(ent), mode=mode,
                                          interpret=True))
    np.testing.assert_array_equal(pairwise_scores(_t(q), _t(ent), mode=mode).numpy(), want)


def test_pairwise_ord_selects_mode_and_block_size_is_invisible():
    q, ent, _, _ = _inputs(6, 70, 10, 1, exact=False, seed=4)
    a = pairwise_scores(_t(q), _t(ent), ord_=2)
    np.testing.assert_array_equal(a.numpy(), pairwise_scores_plain(_t(q), _t(ent), "l2").numpy())
    for block_e in (1, 7, 70, 4096):
        np.testing.assert_array_equal(
            pairwise_scores_plain(_t(q), _t(ent), "l1", block_e=block_e).numpy(),
            pairwise_scores(_t(q), _t(ent), ord_=1).numpy(),
        )


# ------------------------------------------------------------ fused ranks
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("b,e,d,f", SHAPES)
def test_fused_ranks_exact_on_dyadic(b, e, d, f, impl, mode):
    q, ent, gold_idx, filt = _inputs(b, e, d, f, exact=True, seed=1)
    gold, _ = _gold(q, ent, gold_idx, mode)
    want = np.asarray(jax_fused_ranks(jnp.asarray(q), jnp.asarray(ent), jnp.asarray(gold),
                                      jnp.asarray(filt), mode=mode, block_e=64, impl=impl,
                                      interpret=True))
    got = fused_ranks(_t(q), _t(ent), _t(gold), _t(filt), mode=mode, block_e=64)
    assert got.dtype == torch.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fused_ranks_ref(_t(q), _t(ent), _t(gold), _t(filt), mode=mode).numpy(), want
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,e,d,f", SHAPES[:2])
def test_fused_ranks_near_tie_rule_on_continuous(b, e, d, f, mode):
    q, ent, gold_idx, filt = _inputs(b, e, d, f, exact=False, seed=2)
    gold, scores = _gold(q, ent, gold_idx, mode)
    want = np.asarray(jax_fused_ranks(jnp.asarray(q), jnp.asarray(ent), jnp.asarray(gold),
                                      jnp.asarray(filt), mode=mode, impl="pallas",
                                      interpret=True))
    got = fused_ranks(_t(q), _t(ent), _t(gold), _t(filt), mode=mode, block_e=50).numpy()
    assert near_tie_ok(got, want, scores, gold)
    ref = np.asarray(jax_fused_ranks_ref(jnp.asarray(q), jnp.asarray(ent), jnp.asarray(gold),
                                         jnp.asarray(filt), mode=mode))
    assert near_tie_ok(got, ref, scores, gold)


def test_fused_ranks_excludes_filter_and_counts_ties_as_not_beating():
    # every entity identical: all scores tie with gold, none beats it
    q = torch.zeros(3, 4)
    ent = torch.ones(10, 4)
    gold = pairwise_scores_plain(q, ent, "l1")[:, 0]
    filt = torch.full((3, 1), -1, dtype=torch.int32)
    assert fused_ranks(q, ent, gold, filt).tolist() == [0, 0, 0]
    # entity e scores -e; a query with gold at entity 5 is beaten by 0..4,
    # and filtering 1 and 3 (plus an out-of-range id) leaves 3 of them
    ent = torch.arange(10, dtype=torch.float32)[:, None].repeat(1, 4) / 4
    q = torch.zeros(2, 4)
    gold = torch.tensor([-5.0, -5.0])
    filt = torch.tensor([[5, -1, -1, -1], [5, 1, 3, 99]], dtype=torch.int32)
    assert fused_ranks(q, ent, gold, filt, mode="l1").tolist() == [5, 3]
    assert fused_ranks(q, ent, gold, filt[:, :0], mode="l1").tolist() == [5, 5]


def _messy_filter(rng, gold_idx, e, f):
    """Filter rows as callers send them: the gold id, repeats of it and of
    other ids, −1 pads, and ids at or past E."""
    b = len(gold_idx)
    filt = rng.integers(-1, e + 5, (b, f)).astype(np.int32)
    filt[:, 0] = gold_idx
    filt[:, 1] = gold_idx  # the gold id twice
    filt[::2, 2] = filt[::2, 3]  # another repeat
    filt[1::3, -1] = -1
    filt[::4, -2] = e  # one past the last entity
    return filt


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("exact", [True, False], ids=["dyadic", "continuous"])
def test_fused_ranks_count_then_subtract_matches_pallas_on_messy_filters(exact, mode):
    """The plain version counts every entity that beats gold and subtracts
    each distinct filtered id that does: held against the JAX kernel, which
    tests the filter in its tile, on filter rows with repeats, pads and ids
    out of range."""
    b, e, d, f = 12, 200, 16, 9
    rng = np.random.default_rng(17)
    q, ent, _, _ = _inputs(b, e, d, 1, exact=exact, seed=5)
    ent[100:150] = ent[:50]  # exact ties with other entities
    gold_idx = rng.integers(0, e, b)
    filt = _messy_filter(rng, gold_idx, e, f)
    gold, scores = _gold(q, ent, gold_idx, mode)
    want = np.asarray(jax_fused_ranks(jnp.asarray(q), jnp.asarray(ent), jnp.asarray(gold),
                                      jnp.asarray(filt), mode=mode, block_e=64, impl="pallas",
                                      interpret=True))
    got = fused_ranks(_t(q), _t(ent), _t(gold), _t(filt), mode=mode, block_e=48).numpy()
    if exact and mode != "cl1":
        np.testing.assert_array_equal(got, want)
    else:
        assert near_tie_ok(got, want, scores, gold)
    ref = fused_ranks_ref(_t(q), _t(ent), _t(gold), _t(filt), mode=mode).numpy()
    if exact and mode != "cl1":
        np.testing.assert_array_equal(got, ref)
    else:
        assert near_tie_ok(got, ref, scores, gold)


def test_distinct_filter_keeps_each_id_in_range_once():
    filt = torch.tensor([[3, -1, 3, 7, 12, 0], [5, 5, 5, -4, 11, 2]], dtype=torch.int32)
    got = distinct_filter(filt, 12)
    assert got.tolist() == [[-1, -1, 0, 3, -1, 7], [-1, 2, 5, -1, -1, 11]]
    assert distinct_filter(filt[:, :0], 12).shape == (2, 0)


def test_exclusion_mask_matches_membership():
    rng = np.random.default_rng(9)
    filt = rng.integers(-1, 40, (7, 5)).astype(np.int32)
    for c0, c1 in ((0, 40), (10, 17), (39, 40)):
        want = (filt[:, :, None] == np.arange(c0, c1)[None, None, :]).any(1)
        np.testing.assert_array_equal(exclusion_mask(_t(filt), c0, c1).numpy(), want)


def test_wrappers_validate_and_cpu_never_counts_a_launch():
    before = dict(LAUNCHES)
    q, e = torch.zeros(2, 6), torch.zeros(5, 6)
    pairwise_scores(q, e, mode="cl1")
    fused_ranks(q, e, torch.zeros(2), torch.full((2, 1), -1, dtype=torch.int32))
    assert LAUNCHES == before
    with pytest.raises(ValueError):
        pairwise_scores(q, torch.zeros(5, 4))
    with pytest.raises(ValueError):
        pairwise_scores(torch.zeros(2, 5), torch.zeros(3, 5), mode="cl1")
    with pytest.raises(ValueError):
        pairwise_scores(q, e, mode="l3")
    with pytest.raises(ValueError):
        fused_ranks(q, e, torch.zeros(3), torch.full((2, 1), -1, dtype=torch.int32))
    with pytest.raises(ValueError):
        fused_ranks(q, e, torch.zeros(2), torch.full((2,), -1, dtype=torch.int32))
