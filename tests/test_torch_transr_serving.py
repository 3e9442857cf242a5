"""TransR's serving path on the CPU: the projected-rank kernel's plain
version (``kernels.triple_score.projected_ranks_plain``), its dispatch
(``kge.eval.side_counts_graph``), the serving tier's relation groups and
TransR's top-k, against a plain float64 reference (``_torch_transr_ref``)
and against the index-expansion oracle (``generic_counts_graph``).

Counts are held within the reference's near-tie band (1e-5·(1 + |gold|)):
the plain version projects in split TF32 as the kernel does, and sums in
another order than the reference. Run on one intra-op thread, as the
port's other TransR tests are.
"""
import numpy as np
import pytest
import torch
from _torch_transr_ref import rank_bands, tables, topk

from repro_torch.kernels.triple_score import (
    LAUNCHES,
    projected_ranks,
    projected_ranks_plain,
    relation_groups,
    relation_groups_host,
)
from repro_torch.kge import eval as teval
from repro_torch.kge.models import KGEModel, by_relation_group, score_triples
from repro_torch.serving import FilterPack, KGECandidateRanker, KGEServingTier, TableVersion
from repro_torch.serving import engine
from repro_torch.serving.engine import topk_tails_dispatch
from repro_torch.utils import tracing

E, R = 1200, 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(d, seed=3):
    return tables(seed, E, R, d)


def _rows(seed, b, case):
    """(fixed, gold, r, filt) of ``b`` rows: uniform relations, one relation,
    every row its own relation, or rows padded as the tier pads (row 0
    repeated). The filter lists the gold id, some other ids, a repeat and
    pads."""
    g = np.random.default_rng(seed)
    fixed, gold = g.integers(0, E, b), g.integers(0, E, b)
    r = {"uniform": g.integers(0, R, b), "one": np.full(b, 5),
         "distinct": np.arange(b) % R, "padded": g.integers(0, R, b)}[case]
    if case == "padded":
        fixed[b // 2:], gold[b // 2:], r[b // 2:] = fixed[0], gold[0], r[0]
    filt = np.full((b, 6), -1, np.int32)
    filt[:, 0] = gold
    filt[:, 1:4] = g.integers(0, E, (b, 3))
    filt[:, 4] = filt[:, 1]  # a repeated id
    if case == "padded":
        filt[b // 2:] = filt[0]
    return (torch.as_tensor(fixed), torch.as_tensor(gold), torch.as_tensor(r),
            torch.as_tensor(filt))


def _within(got, lo, hi):
    got = np.asarray(got)
    assert ((got >= lo) & (got <= hi)).all(), (got, lo, hi)


@pytest.mark.parametrize("side", ["tail", "head"])
@pytest.mark.parametrize("d", [100, 37])
def test_projected_ranks_plain_within_the_reference_bands(d, side):
    p = _params(d)
    fixed, gold, r, filt = _rows(d, 48, "uniform")
    order, offsets = relation_groups(r)
    got = projected_ranks_plain(p["ent"], p["proj"], p["rel"], fixed, gold, r, filt, order,
                                offsets, side, block_e=500)
    _within(got, *rank_bands(p, fixed, gold, r, filt, side))


@pytest.mark.parametrize("case", ["one", "distinct", "padded"])
def test_projected_ranks_cases_within_the_reference_bands(case):
    p = _params(100, seed=5)
    fixed, gold, r, filt = _rows(11, R if case == "distinct" else 24, case)
    got = projected_ranks(p["ent"], p["proj"], p["rel"], fixed, gold, r, filt, side="tail")
    _within(got, *rank_bands(p, fixed, gold, r, filt, "tail"))
    if case == "padded":  # padded rows count as the row they repeat
        assert (got[len(got) // 2:] == got[0]).all()


def test_relation_groups_on_the_device_and_on_the_host_agree():
    r = np.array([4, 1, 4, 9, 1, 1, 0, 4])
    order, offsets = relation_groups(torch.as_tensor(r))
    horder, hoffsets = relation_groups_host(r)
    np.testing.assert_array_equal(order.numpy(), horder)
    np.testing.assert_array_equal(offsets.numpy(), hoffsets)
    np.testing.assert_array_equal(horder, [6, 1, 4, 5, 0, 2, 7, 3])  # stable within a group
    np.testing.assert_array_equal(hoffsets, [0, 1, 4, 7, 8, 8, 8, 8, 8])


@pytest.mark.parametrize("side", ["tail", "head"])
def test_side_counts_graph_routes_transr_and_matches_the_index_expansion(side):
    d = 24
    p = _params(d, seed=7)
    m = KGEModel("transr", E, R, d)
    fixed, gold, r, filt = _rows(13, 40, "uniform")
    h, t = (fixed, gold) if side == "tail" else (gold, fixed)
    before = LAUNCHES["projected_ranks"]
    got = teval.side_counts_graph(p, m, h, r, t, filt, side=side)
    assert LAUNCHES["projected_ranks"] == before  # the plain version on the CPU
    g = score_triples(p, m, h, r, t)
    want = teval.generic_counts_graph(p, m, *((h, r) if side == "tail" else (r, t)), g, filt,
                                      side=side, block_e=256)
    lo, hi = rank_bands(p, fixed, gold, r, filt, side)
    _within(got, lo, hi)
    _within(want, lo, hi)


def _tier(p, m, known, **kw):
    return KGEServingTier({k: v.clone() for k, v in p.items()}, m, known, device="cpu",
                          max_batch=64, **kw)


def _known(seed, n=3000):
    g = np.random.default_rng(seed)
    return np.stack([g.integers(0, E, n), g.integers(0, R, n), g.integers(0, E, n)], 1)


def test_a_transr_tier_serves_ranks_within_the_reference_bands():
    d = 100
    p = _params(d, seed=9)
    m = KGEModel("transr", E, R, d)
    known = _known(1)
    tier = _tier(p, m, known, warm_buckets=[("rank", 8), ("rank", 64)])
    g = np.random.default_rng(2)
    reqs = []
    for i in range(12):
        q = known[g.integers(0, len(known), 1 + 5 * i % 23)]
        reqs.append((tier.submit_rank(q[:, 0], q[:, 1], q[:, 2]), q))
    tier.run_until_drained()
    ranker = KGECandidateRanker(tier._active.params, m, known)
    for req, q in reqs:
        assert req.state == "served"
        filt = ranker.rank_filter(q[:, 0], q[:, 1], q[:, 2])
        lo, hi = rank_bands(p, q[:, 0], q[:, 2], q[:, 1], filt, "tail")
        _within(req.result - 1, lo, hi)
        # the ranker reaches the same function: the same ranks
        np.testing.assert_array_equal(ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]), req.result)
    assert tier.stats["relation_groups"] >= tier.stats["batches"] > 0


def _traced_batch(tier, q):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
        tier.run_until_drained()
    return tracing.spans()


def test_a_traced_transr_batch_records_its_relation_groups():
    p = _params(16, seed=4)
    m = KGEModel("transr", E, R, 16)
    known = _known(3)
    tier = _tier(p, m, known)
    q = known[:20]
    got = _traced_batch(tier, q)
    grp = [s for s in got if s.name == "tier.group"]
    assert len(grp) == 1
    assert grp[0].attrs["groups"] == len(np.unique(q[:, 1])) == tier.stats["relation_groups"]
    assert grp[0].attrs["rows"] == 32  # the padded bucket
    assert got[grp[0].parent].name == "tier.assemble"


def test_a_transe_batch_does_no_grouping():
    d = 16
    g = torch.Generator().manual_seed(0)
    p = {"ent": torch.rand(E, d, generator=g), "rel": torch.rand(R, d, generator=g)}
    tier = _tier(p, KGEModel("transe", E, R, d), _known(5))
    run, shapes = tier._run, []

    def spy(kind, host_in, *a):
        shapes.append(len(host_in))
        return run(kind, host_in, *a)

    tier._run = spy
    got = _traced_batch(tier, _known(5)[:20])
    assert shapes == [4]  # (h, r, t, filt), as before relation groups existed
    assert not [s for s in got if s.name == "tier.group"]
    assert [s for s in got if s.name == "tier.assemble"]
    assert tier.stats["relation_groups"] == 0


def test_transr_topk_per_relation_group_matches_the_reference():
    d = 32
    p = _params(d, seed=6)
    m = KGEModel("transr", E, R, d)
    g = np.random.default_rng(8)
    h, r = g.integers(0, E, 30), g.integers(0, R, 30)
    filt = np.full((30, 4), -1, np.int32)
    filt[:, :3] = g.integers(0, E, (30, 3))
    k = 7
    vals, ids = topk_tails_dispatch(p, m, torch.as_tensor(h), torch.as_tensor(r),
                                    torch.as_tensor(filt), k=k, block_e=300)
    best, every = topk(p, h, r, filt, k)
    ids = ids.numpy()
    assert (ids >= 0).all()
    served = np.take_along_axis(every, ids.astype(np.int64), 1)
    scale = 1 + np.abs(best)
    assert (np.abs(served - best) <= 1e-5 * scale).all()  # the k best, up to near ties
    assert (np.abs(vals.numpy() - served) <= 1e-5 * scale).all()


def test_transr_under_l2_ranks_and_takes_its_top_k_by_index_expansion_alike():
    """One predicate routes TransR: under L2, which the projected-rank
    kernel does not score, neither the ranks nor the top-k go by relation
    group, and the tier groups nothing."""
    d = 16
    p = _params(d, seed=10)
    m = KGEModel("transr", E, R, d, norm_ord=2)
    assert by_relation_group(KGEModel("transr", E, R, d)) and not by_relation_group(m)
    fixed, gold, r, filt = _rows(17, 20, "uniform")
    got = teval.side_counts_graph(p, m, fixed, r, gold, filt, side="tail", block_e=256)
    want = teval.generic_counts_graph(p, m, fixed, r, score_triples(p, m, fixed, r, gold), filt,
                                      side="tail", block_e=256)
    assert torch.equal(got, want)
    vals, ids = topk_tails_dispatch(p, m, fixed, r, filt, k=5, block_e=300)
    gv, gi = engine._streaming_topk_generic(p, m, fixed, r, filt, k=5, block_e=300)
    assert torch.equal(vals, gv) and torch.equal(ids, gi)
    tier = _tier(p, m, _known(11))
    spans = _traced_batch(tier, _known(11)[:20])
    assert not [s for s in spans if s.name == "tier.group"]
    assert tier.stats["relation_groups"] == 0


def test_a_non_finite_projection_is_refused():
    d = 8
    p = _params(d, seed=2)
    p["proj"][3, 2, 5] = float("nan")
    m = KGEModel("transr", E, R, d)
    tv = TableVersion(p, m, FilterPack(None, E))
    assert tv.rel_bad[3] and tv.rel_bad.sum() == 1
    tier = _tier(p, m, _known(7))
    with pytest.raises(ValueError, match="relation"):
        tier.submit_rank([1], [3], [2])
    tier.submit_rank([1], [4], [2])
    tier.run_until_drained()
