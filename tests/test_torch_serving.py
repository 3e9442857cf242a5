"""Port parity: ``repro_torch.serving`` (tables, ranker, tier) and the
serving subset of ``core.faults`` / ``core.distributed`` against the JAX
package, on the CPU.

Ranks and top-k ids are exact on dyadic tables (the tie rule included);
the tier's results are bit-equal to the port's own ranker and to the JAX
tier; ``ServeFaultPlan`` draws are equal to the JAX package's.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, near_tie_ok, triples

from repro.core import faults as jfaults
from repro.serving import KGECandidateRanker as JaxRanker
from repro.serving import KGEServingTier as JaxTier
from repro.serving import tables as jtables
from repro_torch.core import faults as tfaults
from repro_torch.core.distributed import committed_device, replica_devices
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.triple_score import pairwise_topk_plain
from repro_torch.kge import models as tm
from repro_torch.serving import (
    FilterPack,
    KGECandidateRanker,
    KGEServingTier,
    TableVersion,
    TierOverloadError,
)
from repro_torch.serving.tables import check_id_range

E, R = 300, 6
CPU = torch.device("cpu")


def _tri(n, seed):
    return triples(np.random.default_rng(seed), n, E, R)


@pytest.fixture(scope="module")
def known():
    return _tri(400, 100)


def _world(family="transe", norm_ord=1, d=16, *, dyadic=True, seed=1):
    m, p = jax_params(family, E, R, d, seed=seed, norm_ord=norm_ord, dyadic_tables=dyadic)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return m, jp, tm.KGEModel(family, E, R, d, norm_ord=norm_ord), tm.params_from_numpy(p, CPU)


def _tier(tp, tm_, known, **kw):
    kw.setdefault("block_e", 64)
    kw.setdefault("device", CPU)
    return KGEServingTier(tp, tm_, known, **kw)


def _two_replica_tier(tp, tm_, known, **kw):
    kw.setdefault("max_batch", 8)
    return _tier(tp, tm_, known, replicas=2, devices=[CPU, CPU], device=None, **kw)


def _sums_ok(tier):
    s = tier.stats
    return s["served"] + s["shed"] + s["failed"] == s["submitted"]


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("n", [0, 1, 500])
def test_filter_pack_rows_for_any_key(n):
    """Known keys, unknown keys, a relation past the known ones and
    negative ids: the same rows as the JAX package's ``FilterPack`` (the
    all(−1) sentinel for every key it does not hold), also with no or one
    known triple."""
    rng = np.random.default_rng(n)
    tri = np.stack([rng.integers(0, 40, n), rng.integers(0, 5, n), rng.integers(0, 40, n)], 1)
    a, b = FilterPack(tri, 40), jtables.FilterPack(tri, 40)
    assert a.width == b.width
    np.testing.assert_array_equal(a.rows, b.rows)
    h = np.concatenate([tri[:50, 0], rng.integers(-3, 45, 200)])
    r = np.concatenate([tri[:50, 1], rng.integers(-3, 9, 200)])
    np.testing.assert_array_equal(a.rows_for(h, r), b.rows_for(h, r))


def test_filter_pack_and_id_checks_match(known):
    a, b = FilterPack(known, E), jtables.FilterPack(known, E)
    assert a.width == b.width and a.width & (a.width - 1) == 0
    np.testing.assert_array_equal(a.rows, b.rows)
    assert a.hr_t == b.hr_t and a.rt_h == b.rt_h
    q = _tri(20, 3)
    np.testing.assert_array_equal(a.rows_for(q[:, 0], q[:, 1]), b.rows_for(q[:, 0], q[:, 1]))
    for ids in ([-1, 2], [E, 0], list(range(-7, 0))):
        with pytest.raises(ValueError) as got:
            check_id_range("head entity", ids, E)
        with pytest.raises(ValueError) as want:
            jtables.check_id_range("head entity", ids, E)
        assert str(got.value) == str(want.value)


def test_table_version_bitmask_and_zero_copy_staging(known):
    m, jp, tmod, tp = _world("complex", d=8, dyadic=False)
    bad = {k: np.array(v) for k, v in jp.items()}
    bad["ent"][3, 0] = np.nan
    bad["ent_im"][7, 1] = np.inf
    bad["rel_im"][2, 0] = -np.inf
    jtv = jtables.TableVersion({k: jnp.asarray(v) for k, v in bad.items()}, m,
                               jtables.FilterPack(known, E))
    ttv = TableVersion(tm.params_from_numpy(bad, CPU), tmod, FilterPack(known, E))
    np.testing.assert_array_equal(ttv.ent_bad, jtv.ent_bad)
    np.testing.assert_array_equal(ttv.rel_bad, jtv.rel_bad)
    assert ttv.ent_bad.sum() == 2 and ttv.rel_bad.sum() == 1
    with pytest.raises(ValueError, match=r"entity ids \[3, 7\]"):
        ttv.check_finite("entity", ttv.ent_bad, np.array([3, 7, 9]))
    staged = ttv.on(CPU)
    assert all(staged[k] is ttv.params[k] for k in staged) and ttv.transfers == 0
    assert ttv.on("cpu") is staged
    assert committed_device(tp) == CPU
    assert committed_device({}) is None


def test_replica_ring_and_serving_knobs(monkeypatch):
    devs = [torch.device("cpu", i) for i in range(3)]
    assert replica_devices(1, 2, devs) == [devs[1], devs[2]]
    assert replica_devices(2, 5, devs) == [devs[2], devs[0], devs[1]]
    with pytest.raises(ValueError):
        replica_devices(0, 0, devs)
    assert tdispatch.resolve_serve_impl(None) == "batched"
    monkeypatch.setenv("REPRO_SERVE_IMPL", "direct")
    assert tdispatch.resolve_serve_impl(None) == "direct"
    with pytest.raises(ValueError):
        tdispatch.resolve_serve_impl("fast")
    monkeypatch.setenv("REPRO_SERVE_REPLICAS", "3")
    assert tdispatch.resolve_serve_replicas() == 3 and tdispatch.resolve_serve_replicas(2) == 2
    with pytest.raises(ValueError):
        tdispatch.resolve_serve_replicas(0)
    monkeypatch.setenv("REPRO_SERVE_FAULTS", "off")
    assert tdispatch.resolve_serve_faults(None) is None
    monkeypatch.setenv("REPRO_SERVE_FAULTS", "crash=0.5,seed=3")
    assert tdispatch.resolve_serve_faults(None) == "crash=0.5,seed=3"


# ------------------------------------------------------------------ faults
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_serve_fault_plan_draws_equal_the_jax_package(seed):
    kw = dict(crash=0.25, straggle=0.2, poison=0.15, seed=seed, until=50, delay=0.3, rows=2)
    a, b = tfaults.ServeFaultPlan(**kw), jfaults.ServeFaultPlan(**kw)
    for batch in range(60):
        for rep in range(3):
            x, y = a.draw(batch, rep), b.draw(batch, rep)
            assert (x is None) == (y is None)
            if x is not None:
                assert (x.kind, x.delay, x.rows) == (y.kind, y.delay, y.rows)
    spec = "crash=0.2,straggle=0.1,poison=0.05,seed=7,until=40,delay=0.5,rows=2"
    pa, pb = tfaults.ServeFaultPlan.parse(spec), jfaults.ServeFaultPlan.parse(spec)
    assert [pa.draw(i, 0) and pa.draw(i, 0).kind for i in range(50)] == \
        [pb.draw(i, 0) and pb.draw(i, 0).kind for i in range(50)]
    pinned = tfaults.ServeFaultPlan(table={(2, 1): tfaults.ServeFault("straggle", delay=0.5)})
    assert pinned.draw(2, 1).delay == 0.5 and pinned.draw(2, 0) is None
    for bad in ("explode=1", "crash"):
        with pytest.raises(ValueError):
            tfaults.ServeFaultPlan.parse(bad)
    with pytest.raises(ValueError):
        tfaults.ServeFaultPlan(crash=1.5)
    assert str(tfaults.ServeFaultError("crash", 3, 1)) == str(jfaults.ServeFaultError("crash", 3, 1))


# ------------------------------------------------------------------ ranker
@pytest.mark.parametrize("family,norm_ord,d", [
    ("transe", 1, 32), ("transe", 2, 32), ("distmult", 1, 32), ("complex", 1, 16),
])
def test_ranker_ranks_and_topk_bit_equal_on_dyadic(known, family, norm_ord, d):
    m, jp, tmod, tp = _world(family, norm_ord, d)
    jr, tr = JaxRanker(jp, m, known, block_e=64), KGECandidateRanker(tp, tmod, known, block_e=64)
    q = np.concatenate([_tri(20, 2), known[:12]])
    np.testing.assert_array_equal(tr.rank_tails(q[:, 0], q[:, 1], q[:, 2]),
                                  jr.rank_tails(q[:, 0], q[:, 1], q[:, 2]))
    for k, excl in ((7, True), (1, True), (20, False)):
        ti, tv = tr.topk_tails(q[:, 0], q[:, 1], k=k, exclude_known=excl)
        ji, jv = jr.topk_tails(q[:, 0], q[:, 1], k=k, exclude_known=excl)
        assert ti.dtype == np.int32 and tv.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("family,norm_ord,d", [
    ("transe", 1, 32), ("transe", 2, 32), ("distmult", 1, 32), ("complex", 1, 16),
    ("rotate", 1, 16),
])
def test_pairwise_topk_plain_equals_the_scan_and_the_jax_ranker(known, family, norm_ord, d):
    """The fused top-k kernel's plain version, on each decomposed family's
    query, table and mode (l1, l2, dot, cl1): bit-equal to the ranker's scan
    on the CPU, and to the JAX package's ranker (RotatE's cl1 takes square
    roots the two frameworks round alike only up to near-ties)."""
    m, jp, tmod, tp = _world(family, norm_ord, d)
    jr, tr = JaxRanker(jp, m, known, block_e=64), KGECandidateRanker(tp, tmod, known, block_e=64)
    q = np.concatenate([_tri(20, 2), known[:12]])
    filt = torch.as_tensor(tr.filters.rows_for(q[:, 0], q[:, 1]))
    qv, table, mode = tm.lp_query_tails(tp, tmod, torch.as_tensor(q[:, 0]),
                                        torch.as_tensor(q[:, 1]))
    for k in (1, 7, 16):
        vals, ids = pairwise_topk_plain(qv.contiguous(), table, filt, k, mode, block_e=48)
        ti, tv = tr.topk_tails(q[:, 0], q[:, 1], k=k)
        np.testing.assert_array_equal(ids.numpy(), ti)
        np.testing.assert_array_equal(vals.numpy(), tv)
        ji, jv = jr.topk_tails(q[:, 0], q[:, 1], k=k)
        if family == "rotate":
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
            differ = ti != ji
            assert np.all(np.abs(tv[differ] - jv[differ]) <= 1e-5 * (1 + np.abs(jv[differ])))
        else:
            np.testing.assert_array_equal(ids.numpy(), ji)
            np.testing.assert_array_equal(vals.numpy(), jv)


@pytest.mark.parametrize("family,d", [("rotate", 16), ("transh", 12)])
def test_ranker_near_ties_on_continuous(known, family, d):
    m, jp, tmod, tp = _world(family, d=d, dyadic=False)
    jr, tr = JaxRanker(jp, m, known, block_e=64), KGECandidateRanker(tp, tmod, known, block_e=64)
    q = np.concatenate([_tri(16, 4), known[:8]])
    got = tr.rank_tails(q[:, 0], q[:, 1], q[:, 2]) - 1
    want = jr.rank_tails(q[:, 0], q[:, 1], q[:, 2]) - 1
    scores = tm.score_all_tails(tp, tmod, torch.as_tensor(q[:, 0]),
                                torch.as_tensor(q[:, 1])).numpy()
    assert near_tie_ok(got, want, scores, scores[np.arange(len(q)), q[:, 2]])
    ti, tv = tr.topk_tails(q[:, 0], q[:, 1], k=5)
    ji, jv = jr.topk_tails(q[:, 0], q[:, 1], k=5)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    differ = ti != ji
    # ids may differ only where the two candidates' scores are near-ties
    assert np.all(np.abs(tv[differ] - jv[differ]) <= 1e-5 * (1 + np.abs(jv[differ])))


def test_topk_tie_rule_lower_id_first_and_empty_slots_last():
    """Duplicate entity rows tie exactly: ties go to the lower id, as
    ``lax.top_k`` over ``[carried, block]`` gives them; with most entities
    filtered, the (-inf, -1) initial slots win ties among -inf."""
    e, r, d = 40, 2, 8
    rng = np.random.default_rng(5)
    base = (rng.integers(-64, 65, (5, d)) / 64).astype(np.float32)
    ent = base[rng.integers(0, 5, e)]
    rel = np.zeros((r, d), np.float32)
    p = {"ent": ent, "rel": rel}
    known = np.array([[0, 0, t] for t in range(e - 3)] + [[1, 1, 5]], np.int64)
    m = jax_params("transe", e, r, d)[0]
    tmod = tm.KGEModel("transe", e, r, d)
    jr = JaxRanker({k: jnp.asarray(v) for k, v in p.items()}, m, known, block_e=16)
    tr = KGECandidateRanker(tm.params_from_numpy(p, CPU), tmod, known, block_e=16)
    h, rr = np.array([0, 1, 2, 3]), np.array([0, 1, 0, 1])
    for k in (3, 6, 17, e):
        ti, tv = tr.topk_tails(h, rr, k=k)
        ji, jv = jr.topk_tails(h, rr, k=k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
    assert (ti[0, 3:] == -1).all() and np.isneginf(tv[0, 3:]).all()


def test_ranker_swap_matches_fresh_ranker(known):
    _, _, tmod, tp = _world()
    _, _, _, tp2 = _world(seed=9)
    q = _tri(8, 3)
    ranker = KGECandidateRanker(tp, tmod, known, block_e=64)
    before = ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2])
    ranker.swap(tp2)
    assert ranker.version == 1
    fresh = KGECandidateRanker(tp2, tmod, known, block_e=64)
    np.testing.assert_array_equal(ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]),
                                  fresh.rank_tails(q[:, 0], q[:, 1], q[:, 2]))
    ranker.swap(tp)
    np.testing.assert_array_equal(before, ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]))


# -------------------------------------------------------------------- tier
@pytest.mark.parametrize("family,norm_ord,d", [("transe", 1, 16), ("distmult", 1, 16),
                                               ("transh", 1, 8)])
def test_tier_mixed_traffic_bit_equal_to_ranker_and_jax_tier(known, family, norm_ord, d):
    """Bit-equal to the port's own ranker always, and to the JAX tier on
    dyadic tables; TransH's normalized projections are not exact in fp32,
    so there its top-k scores agree with the JAX tier within 1e-5."""
    m, jp, tmod, tp = _world(family, norm_ord, d)
    ranker = KGECandidateRanker(tp, tmod, known, block_e=64)
    tier = _tier(tp, tmod, known, max_batch=16)
    jtier = JaxTier(jp, m, known, block_e=64, max_batch=16, devices=[jax.devices()[0]])
    reqs = []
    for i, n in enumerate((3, 5, 2, 7, 1, 4)):
        q = _tri(n, 10 + i)
        reqs.append(("rank", q, tier.submit_rank(q[:, 0], q[:, 1], q[:, 2]),
                     jtier.submit_rank(q[:, 0], q[:, 1], q[:, 2])))
    for i, (n, k) in enumerate(((2, 5), (3, 7), (4, 1), (9, 20))):
        q = _tri(n, 20 + i)
        reqs.append(("topk", q, tier.submit_topk(q[:, 0], q[:, 1], k=k),
                     jtier.submit_topk(q[:, 0], q[:, 1], k=k)))
    tier.run_until_drained()
    jtier.run_until_drained()
    # the port's tier counts one more thing, the relation groups of the
    # families that project per relation (none here)
    assert {k: v for k, v in tier.stats.items() if k != "relation_groups"} == jtier.stats
    assert tier.stats["relation_groups"] == 0
    assert tier.stats["batches"] < len(reqs) and tier.stats["failed"] == 0
    for kind, q, req, jreq in reqs:
        assert req.state == jreq.state == "served" and req.version == 0
        if kind == "rank":
            np.testing.assert_array_equal(req.result, jreq.result)
            np.testing.assert_array_equal(req.result, ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]))
        else:
            k = req.k
            ids, vals = ranker.topk_tails(q[:, 0], q[:, 1], k=k)
            if family == "transh":
                np.testing.assert_allclose(req.result[1], jreq.result[1], rtol=0, atol=1e-5)
            else:
                for got, want in zip(req.result, jreq.result):
                    np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(req.result[0], ids)
            np.testing.assert_array_equal(req.result[1], vals)


def test_tier_direct_impl_and_warm_buckets(known):
    _, _, tmod, tp = _world()
    tier = _tier(tp, tmod, known, serve_impl="direct",
                 warm_buckets=[("rank", 3), ("topk", 5, 6)])
    assert tier.stats["warmed"] == 2
    ranker = KGECandidateRanker(tp, tmod, known, block_e=64)
    qs = [_tri(n, 30 + n) for n in (2, 3, 4)]
    reqs = [tier.submit_rank(q[:, 0], q[:, 1], q[:, 2]) for q in qs]
    tier.run_until_drained()
    assert tier.stats["batches"] == len(reqs)
    for q, req in zip(qs, reqs):
        np.testing.assert_array_equal(req.result, ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]))
    with pytest.raises(ValueError, match="warm bucket"):
        _tier(tp, tmod, known, warm_buckets=[("rank", 3, 4)])


def test_tier_validation_and_nonfinite_bitmask(known):
    _, jp, tmod, tp = _world()
    bad = {k: np.array(v) for k, v in jp.items()}
    bad["ent"][3, 0] = np.nan
    bad["rel"][1, 2] = np.inf
    tier = _tier(tm.params_from_numpy(bad, CPU), tmod, None)
    with pytest.raises(ValueError, match=r"head entity ids .*\[-1\]"):
        tier.submit_rank([-1], [0], [1])
    with pytest.raises(ValueError, match=rf"tail entity ids .*\[{E}\]"):
        tier.submit_rank([0], [0], [E])
    with pytest.raises(ValueError, match=r"non-finite query embedding: entity ids \[3\]"):
        tier.submit_rank([3], [0], [1])
    with pytest.raises(ValueError, match=r"relation ids \[1\]"):
        tier.submit_topk([0], [1], k=3)
    with pytest.raises(ValueError, match="k must be in"):
        tier.submit_topk([0], [0], k=0)
    tier.publish(tp)  # a repaired version clears the refusal
    req = tier.submit_rank([3], [0], [1])
    tier.run_until_drained()
    assert req.state == "served" and req.version == 1


def test_tier_max_queue_reject_and_deadline_shed(known):
    _, _, tmod, tp = _world()
    tier = _tier(tp, tmod, known, max_queue=3, max_batch=8)
    q = _tri(2, 9)
    doomed = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2], deadline=0.0)
    live = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    mid = tier.submit_topk(q[:, 0], q[:, 1], k=3, deadline=0.0)
    with pytest.raises(TierOverloadError):
        tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    assert (doomed.state, mid.state, live.state) == ("shed", "shed", "served")
    assert doomed.result is None and doomed.error is None
    s = tier.stats
    assert (s["rejected"], s["submitted"], s["shed"], s["served"]) == (1, 3, 2, 1)
    assert _sums_ok(tier)


def test_tier_pinned_crash_retries_on_same_version(known):
    _, _, tmod, tp = _world()
    _, _, _, tp2 = _world(seed=4)
    plan = tfaults.ServeFaultPlan(table={(0, 0): tfaults.ServeFault("crash")})
    tier = _two_replica_tier(tp, tmod, known, serve_faults=plan)
    q = _tri(5, 1)
    req = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.step()            # seq 0 -> slot 0, pinned to version 0
    tier.publish(tp2)      # the retry must stay on the pinned version
    tier.run_until_drained()
    assert req.state == "served" and req.version == 0
    assert tier.stats["retried"] == 1 and tier.fault_counts == {"crash": 1}
    assert [rp.fails for rp in tier.replicas] == [1, 0]
    want = KGECandidateRanker(tp, tmod, known, block_e=64).rank_tails(q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_array_equal(req.result, want)
    assert _sums_ok(tier)


def test_tier_poison_screen_breaker_and_hedge(known):
    _, _, tmod, tp = _world()
    ranker = KGECandidateRanker(tp, tmod, known, block_e=64)
    q = _tri(4, 4)
    plan = tfaults.ServeFaultPlan(table={(0, 0): tfaults.ServeFault("poison", rows=2)})
    tier = _two_replica_tier(tp, tmod, known, serve_faults=plan)
    req = tier.submit_topk(q[:, 0], q[:, 1], k=5)
    tier.run_until_drained()
    assert req.state == "served" and tier.stats["retried"] == 1
    for got, want in zip(req.result, ranker.topk_tails(q[:, 0], q[:, 1], k=5)):
        np.testing.assert_array_equal(got, want)
    tier = _two_replica_tier(tp, tmod, known, serve_faults=tfaults.ServeFaultPlan(crash=1.0),
                             retry_limit=0, breaker_fails=1)
    failed = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    assert failed.state == "failed" and isinstance(failed.error, tfaults.ServeFaultError)
    assert tier.stats["breaker_open"] == 1 and _sums_ok(tier)
    plan = tfaults.ServeFaultPlan(table={(0, 0): tfaults.ServeFault("straggle", delay=30.0)})
    tier = _two_replica_tier(tp, tmod, known, serve_faults=plan, hedge_after=0.01)
    req = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    assert req.state == "served" and req.latency < 30.0 and tier.stats["hedged"] == 1
    np.testing.assert_array_equal(req.result, ranker.rank_tails(q[:, 0], q[:, 1], q[:, 2]))
    assert all(rp.inflight == 0 for rp in tier.replicas) and not tier._zombies


def test_tier_publish_boundary_and_version_race(known):
    _, jp, tmod, tp = _world()
    _, _, _, tp2 = _world(seed=11)
    tier = _tier(tp, tmod, known, max_batch=8)
    q = _tri(6, 90)
    a = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.step()  # dispatched on v0 before the flip
    tier.publish(tp2)
    b = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    assert (a.version, b.version) == (0, 1) and tier.stats["published"] == 1
    for req, p in ((a, tp), (b, tp2)):
        want = KGECandidateRanker(p, tmod, known, block_e=64).rank_tails(q[:, 0], q[:, 1], q[:, 2])
        np.testing.assert_array_equal(req.result, want)
    # a hot-swap between submit and dispatch that poisons a queried row
    racy = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    p3 = {k: v.clone() for k, v in tp.items()}
    p3["ent"][int(q[0, 0])] = float("nan")
    tier.publish(p3)
    tier.run_until_drained()
    assert racy.state == "failed" and "dispatch version 2" in str(racy.error)
    assert _sums_ok(tier)


def test_tier_without_cuda_and_without_device_raises(known, monkeypatch):
    _, _, tmod, tp = _world()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KGEServingTier(tp, tmod, known)


class _FakeScheduler:
    """The two things a tier needs of a federation scheduler: the owners'
    trainers and KGs, and an accept hook."""

    def __init__(self, params, model, known):
        self.trainers = {"A": SimpleNamespace(params=params, model=model)}
        self.kgs = {"A": SimpleNamespace(train=known[:300], valid=known[300:350],
                                         test=known[350:])}
        self.listeners = []

    def add_accept_listener(self, fn):
        self.listeners.append(fn)

    def accept(self, name, params):
        for fn in self.listeners:
            fn(name, 0, params)


def test_tier_for_owner_republishes_on_accept(known):
    _, _, tmod, tp = _world()
    _, _, _, tp2 = _world(seed=5)
    sched = _FakeScheduler(tp, tmod, known)
    tier = KGEServingTier.for_owner(sched, "A", device=CPU, block_e=64)
    assert tier.owner == "A" and tier.version == 1 and tier.stats["published"] == 1
    sched.accept("B", tp2)  # another owner's accept does not touch this tier
    sched.accept("A", tp2)
    sched.accept("A", {"ent": "garbage", "rel": tp2["rel"]})  # counted, never raised
    assert tier.version == 2 and tier.stats["publish_errors"] == 1
    q = _tri(6, 70)
    req = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    want = KGECandidateRanker(tp2, tmod, known, block_e=64).rank_tails(q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_array_equal(req.result, want)
    assert req.version == 2
    with pytest.raises(ValueError, match="unknown owner"):
        tier.attach(sched, "Z")
