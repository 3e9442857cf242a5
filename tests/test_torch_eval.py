"""Port parity: ``repro_torch.kge.eval`` against the JAX package's
``kge.eval`` on the same tables and queries.

Filter construction is bit-equal. Side counts (tail and head) are exact on
dyadic tables for the l1, l2 and dot families, against both of the JAX
package's rank implementations (the Pallas kernel in interpret mode and the
``lax.scan`` twin); RotatE (``cl1``) and the projection families, whose
scores are not exact in fp32, may differ only by near-ties. Threshold
search is bit-equal, triple classification and the link-prediction metrics
(both engines) equal on dyadic tables.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, near_tie_ok, triples

from repro.kge import eval as jeval
from repro.kge import models as jm
from repro_torch.kge import eval as teval
from repro_torch.kge import models as tm

E, R = 60, 5
EXACT = [("transe", 1, 32), ("transe", 2, 32), ("distmult", 1, 32), ("complex", 1, 16)]
NEAR = [("rotate", 1, 16), ("transh", 1, 12), ("transr", 1, 12), ("transd", 2, 12)]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    known = triples(rng, 300, E, R)
    test = known[rng.choice(len(known), 11, replace=False)]
    return known, test


def _models(family, norm_ord, d, *, dyadic):
    m, p = jax_params(family, E, R, d, seed=2, norm_ord=norm_ord, dyadic_tables=dyadic)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return m, jp, tm.KGEModel(family, E, R, d, norm_ord=norm_ord), tm.params_from_numpy(p, "cpu")


def _jax_counts(jp, m, test, filt, side, impl):
    return np.asarray(jeval.side_counts_graph(
        jp, m, *(jnp.asarray(test[:, i]) for i in range(3)), jnp.asarray(filt),
        side=side, block_e=16, impl=impl,
    ))


def _torch_counts(tp, m, test, filt, side, block_e=16):
    return teval.side_counts_graph(
        tp, m, *(torch.as_tensor(test[:, i]) for i in range(3)), torch.as_tensor(filt),
        side=side, block_e=block_e,
    ).numpy()


def test_filter_construction_bit_equal(world):
    known, test = world
    for filtered in (True, False):
        want = jeval.build_filter_arrays(test, known, filtered=filtered)
        got = teval.build_filter_arrays(test, known, filtered=filtered)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert teval._filter_mask(known, E) == jeval._filter_mask(known, E)
    rows = [[3, 1], [], [7, 8, 9]]
    for width in (None, 3, 8):
        np.testing.assert_array_equal(teval.pack_padded_filters(rows, width=width),
                                      jeval.pack_padded_filters(rows, width=width))
    with pytest.raises(ValueError):
        teval.pack_padded_filters(rows, width=2)


@pytest.mark.parametrize("side", ["tail", "head"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("family,norm_ord,d", EXACT)
def test_side_counts_exact_on_dyadic(world, family, norm_ord, d, impl, side):
    known, test = world
    jmod, jp, tmod, tp = _models(family, norm_ord, d, dyadic=True)
    filt_t, filt_h = jeval.build_filter_arrays(test, known, filtered=True)
    filt = filt_t if side == "tail" else filt_h
    want = _jax_counts(jp, jmod, test, filt, side, impl)
    got = _torch_counts(tp, tmod, test, filt, side)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the block size is invisible
    np.testing.assert_array_equal(_torch_counts(tp, tmod, test, filt, side, block_e=7), want)


@pytest.mark.parametrize("side", ["tail", "head"])
@pytest.mark.parametrize("family,norm_ord,d", NEAR + [("transe", 1, 24), ("complex", 1, 12)])
def test_side_counts_near_ties_on_continuous(world, family, norm_ord, d, side):
    known, test = world
    jmod, jp, tmod, tp = _models(family, norm_ord, d, dyadic=False)
    filt_t, filt_h = jeval.build_filter_arrays(test, known, filtered=True)
    filt = filt_t if side == "tail" else filt_h
    want = _jax_counts(jp, jmod, test, filt, side, "xla")
    got = _torch_counts(tp, tmod, test, filt, side)
    h, r, t = (torch.as_tensor(test[:, i]) for i in range(3))
    if side == "tail":
        scores = tm.score_all_tails(tp, tmod, h, r).numpy()
        gold = scores[np.arange(len(test)), test[:, 2]]
    else:
        scores = tm.score_all_heads(tp, tmod, r, t).numpy()
        gold = scores[np.arange(len(test)), test[:, 0]]
    assert near_tie_ok(got, want, scores, gold)


def test_streaming_and_dispatch_agree_with_graph(world):
    known, test = world
    jmod, jp, tmod, tp = _models("transe", 1, 32, dyadic=True)
    filt_t, filt_h = jeval.build_filter_arrays(test, known, filtered=True)
    for side, filt in (("tail", filt_t), ("head", filt_h)):
        want = np.asarray(jeval.streaming_side_counts(jp, jmod, test, filt, side=side,
                                                      block_e=16))
        got = teval.streaming_side_counts(tp, tmod, test, filt, side=side, block_e=16)
        np.testing.assert_array_equal(got, want)
        disp = teval.side_counts_dispatch(
            tp, tmod, *(torch.as_tensor(test[:, i]) for i in range(3)),
            torch.as_tensor(filt), side=side, block_e=16,
        )
        np.testing.assert_array_equal(disp.numpy(), want)


def test_raw_filters_rank_against_a_brute_force_count(world):
    """Raw mode: the filter holds only the gold id, so the count is the
    number of entities scoring strictly above gold."""
    known, test = world
    _, _, tmod, tp = _models("distmult", 1, 32, dyadic=True)
    filt_t, _ = teval.build_filter_arrays(test, None, filtered=False)
    got = teval.streaming_side_counts(tp, tmod, test, filt_t, side="tail")
    s = tm.score_all_tails(tp, tmod, torch.as_tensor(test[:, 0]),
                           torch.as_tensor(test[:, 1])).numpy()
    gold = s[np.arange(len(test)), test[:, 2]]
    np.testing.assert_array_equal(got, (s > gold[:, None]).sum(1))
    assert jm.MODEL_FAMILIES == tm.MODEL_FAMILIES


@pytest.fixture(scope="module")
def kg(world):
    known, _ = world
    return SimpleNamespace(num_entities=E, num_relations=R, train=known[:240],
                           valid=known[240:270], test=known[270:])


def test_best_threshold_accuracy_bit_equal():
    rng = np.random.default_rng(5)
    for n, m_cand in ((40, 512), (700, 512), (300, 64)):
        pos = rng.normal(1, 1, n).astype(np.float32)
        neg = np.round(rng.normal(0, 1, n), 1).astype(np.float32)  # ties
        assert (teval.best_threshold_accuracy(pos, neg, max_candidates=m_cand)
                == jeval.best_threshold_accuracy(pos, neg, max_candidates=m_cand))


@pytest.mark.parametrize("family,norm_ord,d", EXACT)
def test_triple_classification_accuracy_equal_on_dyadic(kg, family, norm_ord, d):
    jmod, jp, tmod, tp = _models(family, norm_ord, d, dyadic=True)
    for seed in (0, 3):
        assert (teval.triple_classification_accuracy(tp, tmod, kg, seed=seed)
                == jeval.triple_classification_accuracy(jp, jmod, kg, seed=seed))


@pytest.mark.parametrize("family,norm_ord,d", EXACT[:3])
def test_link_prediction_metrics_equal_on_dyadic(kg, family, norm_ord, d):
    jmod, jp, tmod, tp = _models(family, norm_ord, d, dyadic=True)
    for filtered in (True, False):
        want = jeval.link_prediction(jp, jmod, kg, filtered=filtered, batch=8, block_e=16,
                                     engine="reference")
        assert jeval.link_prediction(jp, jmod, kg, filtered=filtered, batch=8,
                                     block_e=16) == want
        for engine in ("auto", "fused", "reference"):
            got = teval.link_prediction(tp, tmod, kg, filtered=filtered, batch=8,
                                        block_e=16, engine=engine)
            assert got == want, (engine, filtered)
    pre = teval.build_score_inputs(kg, max_test=20)
    for g, w in zip(pre, jeval.build_score_inputs(kg, max_test=20)):
        np.testing.assert_array_equal(g, w)
    assert (teval.link_prediction(tp, tmod, kg, precomputed=pre, batch=8)
            == jeval.link_prediction(jp, jmod, kg, max_test=20, batch=8))
    with pytest.raises(ValueError, match="unknown engine"):
        teval.link_prediction(tp, tmod, kg, engine="nope")


def test_streaming_rank_counts_pair_the_two_sides(world):
    known, test = world
    jmod, jp, tmod, tp = _models("transe", 2, 32, dyadic=True)
    filt_t, filt_h = jeval.build_filter_arrays(test, known, filtered=True)
    got = teval.streaming_rank_counts(tp, tmod, test, filt_t, filt_h, block_e=16)
    want = jeval.streaming_rank_counts(jp, jmod, test, filt_t, filt_h, block_e=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
