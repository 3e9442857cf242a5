"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs on a machine that has only
PyTorch (the repo's ``tests/conftest.py`` imports JAX, hence
``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Scores agree within atol 1e-4 / rtol 1e-5. Rank counts differ from the plain
version only by near-ties (entities whose plain score lies within
1e-5·(1+|gold|) of gold), and not at all on dyadic inputs, where every fp32
sum is exact in any order.

The sparse SGD step agrees with its plain version within atol 1e-6 after one
step and 1e-5 after 64 (loss rtol 1e-6); on dyadic tables it is bit-equal
to the plain version on the CPU (which sums in the kernel's order), and two
runs of the kernel are always bit-equal. The epoch kernel (all steps of an
epoch in one cluster launch) is held the same way against the plain step
loop: bit-equal over l1 epochs on dyadic tables (the tables stay exact), on
a 12-row table too, where every step re-reads rows the step before wrote
on another SM; within 1e-5 after 64 steps at Dbpedia's size; bit-equal
between reruns.

The cosine kernel agrees with its plain version within atol 1e-5 (zero rows
give exactly 0); blockwise CSLS argmaxes equal the full matrix's up to
near-ties (1e-5). Sixteen PPAT rounds on the card give the CPU's vote counts
and W within 1e-4.

Flash attention agrees with its dense plain version within 1e-5 (atol and
rtol) at fp32 and within one bf16 ulp (rtol 2**-7, atol 1e-5) at bf16; where
the scores are ~50-60 (qk-norm off), fp32 rounding alone moves the output by
more than 1e-5, so there the fp32 kernel is held within twice the plain
version's own distance from a float64 truth. The
SSD chunk kernel agrees with its plain version within 1e-5 of the largest
output magnitude (both sum ``cum`` in the same order), the whole SSD with the plain chunk loop within 1e-3 of it.
A reduced LM card served on the card gives the CPU engine's tokens up to
near-ties (1e-4 of the logits).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.triple_score import (
    LAUNCHES,
    fused_ranks,
    fused_ranks_plain,
    pairwise_scores,
    pairwise_scores_plain,
    pairwise_topk,
    pairwise_topk_cap,
    pairwise_topk_plain,
)
from repro_torch.kernels.triple_score.ops import topk_scan
from repro_torch.kernels.sparse_update import LAUNCHES as STEP_LAUNCHES
from repro_torch.kernels.sparse_update import STEPS as STEP_STEPS
from repro_torch.kernels.sparse_update import (
    fused_sparse_epoch,
    fused_sparse_step,
    sparse_epoch_plain,
    sparse_step_plain,
)
from repro_torch.kge.models import KGEModel, params_from_numpy
from repro_torch.kge.trainer import KGETrainer
from repro_torch.serving import KGECandidateRanker, KGEServingTier
from repro_torch.serving import engine as serving_engine


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc for sm_90a")
    return torch.device("cuda", 0)


def _near_tie_ok(got, want, scores, gold):
    g = gold[:, None]
    near = ((scores - g).abs() <= 1e-5 * (1 + g.abs())).sum(1)
    return bool(((got.long() - want.long()).abs() <= near).all())


def _dyadic(rng, shape):
    return (rng.integers(-64, 65, shape) / 64.0).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,d", [("l1", 100), ("l2", 100), ("dot", 100), ("dot", 200),
                                    ("cl1", 100), ("l1", 7), ("cl1", 10), ("l2", 1)])
@pytest.mark.parametrize("b,e,f", [(64, 5000, 1), (61, 4963, 33), (5, 100, 3), (130, 70, 2)])
def test_kernels_match_plain(cuda_dev, mode, d, b, e, f):
    if mode == "cl1" and d % 2:
        pytest.skip("cl1 needs an even width")
    g = torch.Generator(device=cuda_dev).manual_seed(b * e + d)
    q = torch.randn(b, d, device=cuda_dev, generator=g)
    ent = torch.randn(e, d, device=cuda_dev, generator=g)
    before = dict(LAUNCHES)
    s = pairwise_scores(q, ent, mode=mode)
    p = pairwise_scores_plain(q, ent, mode)
    torch.testing.assert_close(s, p, atol=1e-4, rtol=1e-5)
    gi = torch.randint(0, e, (b,), device=cuda_dev, generator=g)
    filt = torch.randint(-1, e, (b, f), device=cuda_dev, generator=g, dtype=torch.int32)
    filt[:, 0] = gi.int()
    gold = p[torch.arange(b, device=cuda_dev), gi]
    got = fused_ranks(q, ent, gold, filt, mode=mode)
    want = fused_ranks_plain(q, ent, gold, filt, mode)
    assert _near_tie_ok(got, want, p, gold)
    assert LAUNCHES["pairwise_scores"] == before["pairwise_scores"] + 1
    assert LAUNCHES["fused_ranks"] == before["fused_ranks"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_kernels_exact_on_dyadic(cuda_dev, mode):
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_dyadic(rng, (37, 32))).to(cuda_dev)
    ent = torch.from_numpy(_dyadic(rng, (3001, 32))).to(cuda_dev)
    ent[1000:1100] = ent[:100]  # exact ties
    s = pairwise_scores(q, ent, mode=mode)
    p = pairwise_scores_plain(q, ent, mode)
    assert torch.equal(s, p)
    gi = torch.arange(37, device=cuda_dev) * 7
    filt = torch.stack([gi, gi + 1000], 1).int()
    gold = p[torch.arange(37, device=cuda_dev), gi]
    assert torch.equal(fused_ranks(q, ent, gold, filt, mode=mode),
                       fused_ranks_plain(q, ent, gold, filt, mode))


def _messy_filter(g, dev, gi, e, f):
    """Filter rows with the gold id twice, other repeats, −1 pads and ids at
    or past E."""
    b = gi.shape[0]
    filt = torch.randint(-1, e + 5, (b, f), device=dev, generator=g, dtype=torch.int32)
    filt[:, 0] = gi.int()
    if f > 3:
        filt[:, 1] = gi.int()
        filt[::2, 2] = filt[::2, 3]
        filt[1::3, -1] = -1
        filt[::4, -2] = e
    return filt


def _check_both(q, ent, mode, f, g, exact):
    """Both kernels against their plain versions on (q, ent): scores within
    atol 1e-4 / rtol 1e-5 (bit-equal when ``exact``), rank counts up to
    near-ties (bit-equal when ``exact``), one launch each."""
    dev = q.device
    b, e = q.shape[0], ent.shape[0]
    before = dict(LAUNCHES)
    s = pairwise_scores(q, ent, mode=mode)
    p = pairwise_scores_plain(q, ent, mode)
    if exact:
        assert torch.equal(s, p)
    else:
        torch.testing.assert_close(s, p, atol=1e-4, rtol=1e-5)
    gi = torch.randint(0, e, (b,), device=dev, generator=g)
    filt = _messy_filter(g, dev, gi, e, f)
    gold = p[torch.arange(b, device=dev), gi]
    got = fused_ranks(q, ent, gold, filt, mode=mode)
    want = fused_ranks_plain(q, ent, gold, filt, mode)
    if exact:
        assert torch.equal(got, want)
    else:
        assert _near_tie_ok(got, want, p, gold)
    assert LAUNCHES["pairwise_scores"] == before["pairwise_scores"] + 1
    assert LAUNCHES["fused_ranks"] == before["fused_ranks"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot", "cl1"])
@pytest.mark.parametrize("b", [1, 8, 9, 63, 64, 65, 128])
def test_kernels_across_query_tiles(cuda_dev, b, mode):
    """Every query-tile choice (8, 16, 32, 64 rows, and two grid rows past
    64) on a table that ends in a ragged entity tile."""
    g = torch.Generator(device=cuda_dev).manual_seed(b)
    q = torch.randn(b, 100, device=cuda_dev, generator=g)
    ent = torch.randn(3001, 100, device=cuda_dev, generator=g)
    _check_both(q, ent, mode, 6, g, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,d", [("l1", 7), ("l2", 7), ("dot", 7), ("l1", 10), ("cl1", 10),
                                    ("l1", 102), ("cl1", 102), ("l2", 102), ("dot", 300),
                                    ("l1", 300), ("cl1", 300), ("l2", 257)])
@pytest.mark.parametrize("b", [5, 64])
def test_kernels_on_unaligned_and_chunked_rows(cuda_dev, mode, d, b):
    """Rows that are not 16-byte aligned (d % 4 != 0, cl1 halves of odd or
    unaligned width) take the 4-byte copies; rows past one stage's columns
    (d 257, 300) are scored in several chunks."""
    g = torch.Generator(device=cuda_dev).manual_seed(b * d)
    q = torch.randn(b, d, device=cuda_dev, generator=g)
    ent = torch.randn(1500, d, device=cuda_dev, generator=g)
    _check_both(q, ent, mode, 4, g, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot", "cl1"])
@pytest.mark.parametrize("d", [7, 100, 102])
def test_kernels_on_unaligned_chunk_views(cuda_dev, mode, d):
    """A chunk view ``table[c0:c1]`` as the top-k path passes it, whose
    first row is not 16-byte aligned where d % 4 != 0."""
    if mode == "cl1" and d % 2:
        d *= 2  # an even width with an odd half (d / 2 = 7)
    g = torch.Generator(device=cuda_dev).manual_seed(d)
    q = torch.randn(64, d, device=cuda_dev, generator=g)
    table = torch.randn(2000, d, device=cuda_dev, generator=g)
    view = table[3:1700]
    assert view.is_contiguous()
    if d % 4:
        assert view.data_ptr() % 16 != 0
    _check_both(q, view, mode, 5, g, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
@pytest.mark.parametrize("b,f", [(1, 5), (8, 2000), (64, 9), (65, 33), (128, 2000)])
def test_fused_ranks_bit_equal_on_dyadic_ties_and_messy_filters(cuda_dev, mode, b, f):
    """Dyadic tables, where every sum is exact: many exact ties with gold,
    filter rows with repeats, pads, ids past E and up to 2,000 slots (the
    filter is never staged in shared memory): scores and rank counts
    bit-equal to the plain versions."""
    rng = np.random.default_rng(b + f)
    q = torch.from_numpy(_dyadic(rng, (b, 32))).to(cuda_dev)
    ent = torch.from_numpy(_dyadic(rng, (4100, 32))).to(cuda_dev)
    ent[2000:2500] = ent[:500]  # exact ties
    ent[3000:3010] = q[:1].expand(10, -1)  # exact ties with the query itself
    g = torch.Generator(device=cuda_dev).manual_seed(b * f)
    _check_both(q, ent, mode, f, g, exact=True)


@pytest.mark.cuda
def test_tier_on_the_card_equals_the_cpu_tier(cuda_dev):
    """Mixed rank/top-k traffic through the tier on the card (kernels) and
    on the CPU (plain versions), on dyadic tables: bit-equal."""
    e, r, d = 5000, 7, 32
    rng = np.random.default_rng(0)
    p = {"ent": _dyadic(rng, (e, d)), "rel": _dyadic(rng, (r, d))}
    known = np.stack([rng.integers(0, e, 3000), rng.integers(0, r, 3000),
                      rng.integers(0, e, 3000)], 1)
    m = KGEModel("transe", e, r, d)
    tiers = [KGEServingTier(params_from_numpy(p, dev), m, known, device=dev, block_e=512)
             for dev in (cuda_dev, torch.device("cpu"))]
    before = dict(LAUNCHES)
    reqs = []
    for i in range(30):
        q = known[rng.integers(0, len(known), 1 + i % 9)]
        if i % 3:
            reqs.append([t.submit_rank(q[:, 0], q[:, 1], q[:, 2]) for t in tiers])
        else:
            reqs.append([t.submit_topk(q[:, 0], q[:, 1], k=1 + i % 20) for t in tiers])
    for t in tiers:
        t.run_until_drained()
    for a, b in reqs:
        assert a.state == b.state == "served"
        if a.kind == "rank":
            np.testing.assert_array_equal(a.result, b.result)
        else:
            for x, y in zip(a.result, b.result):
                np.testing.assert_array_equal(x, y)
    assert LAUNCHES["fused_ranks"] > before["fused_ranks"]
    assert LAUNCHES["pairwise_topk"] > before["pairwise_topk"]
    assert LAUNCHES["pairwise_scores"] == before["pairwise_scores"]
    q = known[:16]
    on_card, on_cpu = (KGECandidateRanker(t._active.params, m, known)
                       .rank_tails(q[:, 0], q[:, 1], q[:, 2]) for t in tiers)
    np.testing.assert_array_equal(on_card, on_cpu)


def _topk_case(dev, b, e, d, filt_kind, seed):
    """Dyadic queries and a table of repeated rows (exact ties, which go to
    the lower id), and a filter of one kind: none (width 0), messy (−1 pads,
    repeats, ids at and past E) or all but three entities listed."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(_dyadic(rng, (b, d))).to(dev)
    rows = max(e // 4, 1)
    ent = torch.from_numpy(_dyadic(rng, (rows, d))[rng.integers(0, rows, e)]).to(dev)
    if filt_kind == "none":
        filt = np.zeros((b, 0), np.int32)
    elif filt_kind == "messy":
        filt = rng.integers(-1, e + 4, (b, 9)).astype(np.int32)
        filt[::2, 1] = filt[::2, 0]
        filt[1::3, -1] = -1
        filt[::4, -2] = e
    else:
        filt = np.full((b, e), -1, np.int32)
        for i in range(b):
            keep = rng.choice(e, 3, replace=False)
            listed = np.setdiff1d(np.arange(e), keep)
            filt[i, :len(listed)] = rng.permutation(listed)
    return q, ent, torch.from_numpy(filt).to(dev)


def _check_topk(q, ent, filt, k, mode):
    """The serving path's top-k dispatch against the blockwise scan over the
    pairwise kernel, bit for bit in values and ids; one fused launch and no
    pairwise launch where k fits the fused kernel, the scan past its cap."""
    e = ent.shape[0]
    want_v, want_i = topk_scan(lambda c0, c1: pairwise_scores(q, ent[c0:c1], mode=mode),
                               q.shape[0], e, filt, k=k, chunk=1000, device=q.device)
    fused = min(k, e) <= pairwise_topk_cap(q.shape[1], mode, q.device)
    before = dict(LAUNCHES)
    vals, ids = serving_engine._streaming_topk_decomposed(q, ent, filt, k=k, block_e=2048,
                                                          mode=mode)
    assert torch.equal(vals, want_v) and torch.equal(ids, want_i)
    if fused:
        assert LAUNCHES["pairwise_topk"] == before["pairwise_topk"] + 1
        assert LAUNCHES["pairwise_scores"] == before["pairwise_scores"]
    else:
        assert LAUNCHES["pairwise_topk"] == before["pairwise_topk"]
        assert LAUNCHES["pairwise_scores"] > before["pairwise_scores"]
    return vals, ids


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot", "cl1"])
@pytest.mark.parametrize("b", [1, 7, 64, 65, 2048])
@pytest.mark.parametrize("kb", ["1", "16", "64", "cap", "cap+1"])
def test_pairwise_topk_bit_equal_to_the_scan(cuda_dev, mode, b, kb):
    """Every query tile (B 1 to 2,048, several grid rows), k from 1 to the
    kernel's cap, and the cap + 1, which goes to the scan, on a ragged table
    (3,001 rows) with messy filters."""
    cap = pairwise_topk_cap(100, mode, cuda_dev)
    assert cap >= 64
    k = {"cap": cap, "cap+1": cap + 1}.get(kb) or int(kb)
    q, ent, filt = _topk_case(cuda_dev, b, 3001, 100, "messy", seed=b * 7 + k)
    _check_topk(q, ent, filt, k, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot", "cl1"])
@pytest.mark.parametrize("filt_kind", ["none", "messy", "all-but-three"])
@pytest.mark.parametrize("b,e,d,k", [(7, 1000, 100, 16), (65, 129, 100, 64), (9, 13, 100, 64),
                                     (5, 300, 14, 10)],
                         ids=["ragged", "one-tile-past", "e-below-k", "unaligned-rows"])
def test_pairwise_topk_filters_and_small_tables(cuda_dev, mode, filt_kind, b, e, d, k):
    """Filters of width 0, messy ones, and all but three entities listed
    (the width of the table, too wide to stage in shared memory): the
    three come first and (−inf, −1) fills the rest; tables of one tile
    past a multiple of 128, fewer rows than k, and rows that are not
    16-byte aligned."""
    q, ent, filt = _topk_case(cuda_dev, b, e, d, filt_kind, seed=e + k)
    vals, ids = _check_topk(q, ent, filt, k, mode)
    assert vals.shape == (b, min(k, e))
    if filt_kind == "all-but-three":
        assert (ids[:, 3:] == -1).all() and torch.isneginf(vals[:, 3:]).all()
        assert (ids[:, :3] >= 0).all()
    if mode != "cl1":  # dyadic sums are exact in any order; cl1 takes square roots
        plain_v, plain_i = pairwise_topk_plain(q.cpu(), ent.cpu(), filt.cpu(), k, mode)
        assert torch.equal(ids.cpu(), plain_i) and bool((vals.cpu() == plain_v).all())


@pytest.mark.cuda
def test_pairwise_topk_counts_one_launch_per_tier_batch(cuda_dev):
    """A top-k run of the tier: one fused launch per dispatched batch, no
    pairwise launch; and the wrapper refuses k above its cap."""
    e, r, d = 4000, 5, 100
    rng = np.random.default_rng(3)
    p = {"ent": _dyadic(rng, (e, d)), "rel": _dyadic(rng, (r, d))}
    known = np.stack([rng.integers(0, e, 2000), rng.integers(0, r, 2000),
                      rng.integers(0, e, 2000)], 1)
    tier = KGEServingTier(params_from_numpy(p, cuda_dev), KGEModel("transe", e, r, d), known,
                          device=cuda_dev, max_batch=64)
    batches, before = tier.stats["batches"], dict(LAUNCHES)
    for i in range(40):
        q = known[rng.integers(0, len(known), 1 + i % 23)]
        tier.submit_topk(q[:, 0], q[:, 1], k=10)
    tier.run_until_drained()
    assert LAUNCHES["pairwise_topk"] - before["pairwise_topk"] == tier.stats["batches"] - batches
    assert LAUNCHES["pairwise_scores"] == before["pairwise_scores"]
    cap = pairwise_topk_cap(d, "l1", cuda_dev)
    q = torch.zeros(2, d, device=cuda_dev)
    with pytest.raises(ValueError):
        pairwise_topk(q, tier._active.params["ent"], torch.full((2, 1), -1, dtype=torch.int32,
                                                                 device=cuda_dev), k=cap + 1)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_dev):
    q = torch.zeros(2, 8, device=cuda_dev)
    ent = torch.zeros(5, 8, device=cuda_dev)
    with pytest.raises(TypeError):
        pairwise_scores(q.double(), ent.double())
    with pytest.raises(ValueError):
        pairwise_scores(q, torch.zeros(8, 5, device=cuda_dev).T)
    with pytest.raises(ValueError):
        pairwise_scores(q, ent.cpu())
    with pytest.raises(TypeError):
        fused_ranks(q, ent, torch.zeros(2, device=cuda_dev),
                    torch.zeros(2, 1, dtype=torch.int64, device=cuda_dev))


def _hard_batch(rng, e, r, b):
    """(pos, neg) int64 (b, 3): a hub entity in most occurrences, ids 0 and
    e−1, and rows shared between pos and neg."""
    pos = np.stack([rng.integers(0, e, b), rng.integers(0, r, b), rng.integers(0, e, b)], 1)
    neg = pos.copy()
    side = rng.random(b) < 0.5
    rand = rng.integers(0, e, b)
    neg[side, 0] = rand[side]
    neg[~side, 2] = rand[~side]
    hub = e // 2
    pos[: (2 * b) // 3, 0] = hub
    neg[: b // 3, 2] = hub
    pos[-1, 2] = 0
    neg[-1, 0] = e - 1
    if b > 2:
        neg[1, 0] = pos[2, 2]
    return torch.as_tensor(pos.astype(np.int64)), torch.as_tensor(neg.astype(np.int64))


def _step_tables(rng, e, r, d, dev):
    return (torch.as_tensor(rng.normal(0, 0.3, (e, d)).astype(np.float32), device=dev),
            torch.as_tensor(rng.normal(0, 0.3, (r, d)).astype(np.float32), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
@pytest.mark.parametrize("b,d", [(100, 100), (37, 33), (1, 7), (257, 128), (8, 1),
                                 (544, 100)])
def test_sparse_step_matches_plain(cuda_dev, mode, b, d):
    rng = np.random.default_rng(b * 131 + d)
    e, r = 5000, 40
    ent, rel = _step_tables(rng, e, r, d, cuda_dev)
    pos, neg = (x.to(cuda_dev) for x in _hard_batch(rng, e, r, b))
    pe, pr = ent.clone(), rel.clone()
    before = STEP_LAUNCHES["sparse_sgd_step"]
    out_e, out_r, loss = fused_sparse_step(ent, rel, pos, neg, 0.5, mode=mode, margin=4.0)
    assert out_e is ent and out_r is rel
    assert STEP_LAUNCHES["sparse_sgd_step"] == before + 1
    ploss = sparse_step_plain(pe, pr, pos, neg, 0.5, mode=mode, margin=4.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(ent, pe, atol=1e-6, rtol=0)
    torch.testing.assert_close(rel, pr, atol=1e-6, rtol=0)
    torch.testing.assert_close(loss, ploss, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_sparse_step_64_steps_and_bit_equal_reruns(cuda_dev, mode):
    rng = np.random.default_rng(7)
    e, r, d, b = 3000, 30, 100, 100
    start = _step_tables(rng, e, r, d, cuda_dev)
    batches = [tuple(x.to(cuda_dev) for x in _hard_batch(rng, e, r, b)) for _ in range(64)]
    runs = []
    for _ in range(2):
        ent, rel = (t.clone() for t in start)
        losses = [fused_sparse_step(ent, rel, p, n, 0.5, mode=mode)[2] for p, n in batches]
        runs.append((ent, rel, torch.stack(losses)))
    pe, pr = (t.clone() for t in start)
    plosses = torch.stack([sparse_step_plain(pe, pr, p, n, 0.5, mode=mode) for p, n in batches])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(runs[0], runs[1]))
    torch.testing.assert_close(runs[0][0], pe, atol=1e-5, rtol=0)
    torch.testing.assert_close(runs[0][1], pr, atol=1e-5, rtol=0)
    torch.testing.assert_close(runs[0][2], plosses, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_sparse_step_bit_equal_on_dyadic(cuda_dev, mode):
    rng = np.random.default_rng(11)
    e, r, d, b = 500, 9, 16, 8
    ent = torch.as_tensor(_dyadic(rng, (e, d)))
    rel = torch.as_tensor(_dyadic(rng, (r, d)))
    pos, neg = _hard_batch(rng, e, r, b)
    ke, kr = ent.clone().to(cuda_dev), rel.clone().to(cuda_dev)
    _, _, kl = fused_sparse_step(ke, kr, pos.to(cuda_dev), neg.to(cuda_dev), 0.5, mode=mode)
    pl = sparse_step_plain(ent, rel, pos, neg, 0.5, mode=mode)
    assert torch.equal(ke.cpu(), ent) and torch.equal(kr.cpu(), rel)
    assert torch.equal(kl.cpu(), pl)


@pytest.mark.cuda
def test_sparse_step_wrapper_raises_on_what_the_kernel_does_not_take(cuda_dev):
    ent = torch.zeros(50, 8, device=cuda_dev)
    rel = torch.zeros(5, 8, device=cuda_dev)
    pos = torch.zeros(4, 3, dtype=torch.int64, device=cuda_dev)
    with pytest.raises(TypeError):
        fused_sparse_step(ent.double(), rel.double(), pos, pos, 0.5)
    with pytest.raises(TypeError):
        fused_sparse_step(ent, rel, pos.int(), pos.int(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        fused_sparse_step(torch.zeros(8, 50, device=cuda_dev).T, rel, pos, pos, 0.5)
    with pytest.raises(ValueError, match="different devices"):
        fused_sparse_step(ent, rel.cpu(), pos, pos, 0.5)
    big = torch.zeros(10_000, 3, dtype=torch.int64, device=cuda_dev)
    with pytest.raises(ValueError, match="shared memory"):
        fused_sparse_step(ent, rel, big, big, 0.5)


def _epoch(rng, e, r, b, nb, dev):
    batches = [_hard_batch(rng, e, r, b) for _ in range(nb)]
    return (torch.stack([p for p, _ in batches]).to(dev),
            torch.stack([n for _, n in batches]).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("e,nb", [(500, 16), (12, 32)], ids=["e500", "tiny-table"])
def test_sparse_epoch_bit_equal_on_dyadic(cuda_dev, e, nb):
    """l1 steps on dyadic tables stay exact, so the epoch kernel must equal
    the plain loop on the CPU bit for bit, loss by loss. On the 12-row table
    every step re-reads rows that the step before wrote, from other SMs of
    the cluster: a stale read through L1 or the read-only path would show."""
    rng = np.random.default_rng(e + nb)
    r, d, b = 3, 16, 8
    ent = torch.as_tensor(_dyadic(rng, (e, d)))
    rel = torch.as_tensor(_dyadic(rng, (r, d)))
    pos, neg = _epoch(rng, e, r, b, nb, torch.device("cpu"))
    ke, kr = ent.clone().to(cuda_dev), rel.clone().to(cuda_dev)
    before = STEP_LAUNCHES["sparse_sgd_step"], STEP_STEPS["sparse_sgd_step"]
    kl = fused_sparse_epoch(ke, kr, pos.to(cuda_dev), neg.to(cuda_dev), 0.5, mode="l1")
    assert STEP_LAUNCHES["sparse_sgd_step"] == before[0] + 1  # one launch for the epoch
    assert STEP_STEPS["sparse_sgd_step"] == before[1] + nb
    start = ent.clone()
    pl = sparse_epoch_plain(ent, rel, pos, neg, 0.5, mode="l1")
    assert not torch.equal(ent, start)
    assert torch.equal(ke.cpu(), ent) and torch.equal(kr.cpu(), rel)
    assert torch.equal(kl.cpu(), pl)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_sparse_epoch_tiny_table_matches_plain(cuda_dev, mode):
    """64 steps on a 12-row table with continuous values, every mode: rows
    written by one step are read by the next (stale reads would be off by a
    whole update, ~1e-2), held within 1e-5 of the plain loop on the card."""
    rng = np.random.default_rng(40)
    e, r, d, b, nb = 12, 3, 33, 8, 64
    ent, rel = _step_tables(rng, e, r, d, cuda_dev)
    pos, neg = _epoch(rng, e, r, b, nb, cuda_dev)
    pe, pr = ent.clone(), rel.clone()
    kl = fused_sparse_epoch(ent, rel, pos, neg, 0.1, mode=mode)
    pl = sparse_epoch_plain(pe, pr, pos, neg, 0.1, mode=mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(ent, pe, atol=1e-5, rtol=0)
    torch.testing.assert_close(rel, pr, atol=1e-5, rtol=0)
    torch.testing.assert_close(kl, pl, atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["l1", "l2", "dot"])
def test_sparse_epoch_64_steps_at_dbpedia_size(cuda_dev, mode):
    """64 steps at the training shape (E = 491,078, R = 14,085, d = 100,
    B = 100): within 1e-5 of the plain loop on the card; three runs
    bit-equal."""
    rng = np.random.default_rng(64)
    e, r, d, b, nb = 491_078, 14_085, 100, 100, 64
    start = _step_tables(rng, e, r, d, cuda_dev)
    pos, neg = _epoch(rng, e, r, b, nb, cuda_dev)
    runs = []
    for _ in range(3):
        ent, rel = (t.clone() for t in start)
        losses = fused_sparse_epoch(ent, rel, pos, neg, 0.5, mode=mode)
        runs.append((ent, rel, losses))
    pe, pr = (t.clone() for t in start)
    pl = sparse_epoch_plain(pe, pr, pos, neg, 0.5, mode=mode)
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], other))
    torch.testing.assert_close(runs[0][0], pe, atol=1e-5, rtol=0)
    torch.testing.assert_close(runs[0][1], pr, atol=1e-5, rtol=0)
    torch.testing.assert_close(runs[0][2], pl, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [100, 544])
def test_sparse_epoch_at_the_batch_caps(cuda_dev, b):
    """The trainer's batch and the largest batch whose gradient rows fit the
    cluster's shared memory at d = 100; one past that raises."""
    rng = np.random.default_rng(b)
    e, r, d, nb = 5000, 40, 100, 3
    ent, rel = _step_tables(rng, e, r, d, cuda_dev)
    pos, neg = _epoch(rng, e, r, b, nb, cuda_dev)
    pe, pr = ent.clone(), rel.clone()
    kl = fused_sparse_epoch(ent, rel, pos, neg, 0.5, mode="l2")
    pl = sparse_epoch_plain(pe, pr, pos, neg, 0.5, mode="l2")
    torch.cuda.synchronize()
    torch.testing.assert_close(ent, pe, atol=1e-5, rtol=0)
    torch.testing.assert_close(rel, pr, atol=1e-5, rtol=0)
    torch.testing.assert_close(kl, pl, rtol=1e-5, atol=1e-6)
    if b == 544:
        big = torch.zeros(1, b + 1, 3, dtype=torch.int64, device=cuda_dev)
        with pytest.raises(ValueError, match="shared memory"):
            fused_sparse_epoch(ent, rel, big, big, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("family,norm_ord,impl", [("transe", 1, "fused"),
                                                  ("transe", 2, "fused"),
                                                  ("distmult", 1, "fused"),
                                                  ("transh", 1, "sparse")])
def test_trainer_on_the_card_equals_the_cpu_trainer(cuda_dev, family, norm_ord, impl):
    """The same start tables and the same explicit draws through the trainer
    on the card (kernel) and on the CPU (plain version): within 1e-5."""
    import dataclasses
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    e, r, d, n, b = 3000, 20, 32, 2000, 100
    tri = np.stack([rng.integers(0, e, n), rng.integers(0, r, n), rng.integers(0, e, n)], 1)
    kg = SimpleNamespace(num_entities=e, num_relations=r, train=tri.astype(np.int32))
    trainers = [KGETrainer(kg, family, dim=d, seed=0, device=dev)
                for dev in (cuda_dev, torch.device("cpu"))]
    start = {k: v.cpu() for k, v in trainers[0].params.items()}
    for t in trainers:
        t.model = dataclasses.replace(t.model, norm_ord=norm_ord)
        t.params = {k: v.to(t.device) for k, v in start.items()}
    nb = 32  # 20 batches, cycle-padded to a power of two
    n_pad = nb * b
    draws = [(rng.permutation(n_pad), rng.random((nb, b)) < 0.5, rng.integers(0, e, (nb, b)))
             for _ in range(3)]
    before = STEP_LAUNCHES["sparse_sgd_step"], STEP_STEPS["sparse_sgd_step"]
    losses = [t.train_epochs(3, impl=impl, draws=draws) for t in trainers]
    if impl == "fused":  # one launch per epoch, nb steps each
        assert STEP_LAUNCHES["sparse_sgd_step"] == before[0] + 3
        assert STEP_STEPS["sparse_sgd_step"] == before[1] + 3 * nb
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    for k in start:
        torch.testing.assert_close(trainers[0].params[k].cpu(), trainers[1].params[k],
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------------ csls
@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(1000, 777, 100), (129, 4097, 33), (128, 128, 16),
                                   (1, 1, 1), (300, 5, 200), (257, 130, 100),
                                   (129, 129, 100), (129, 257, 104), (257, 129, 128),
                                   (129, 4097, 1)])
def test_cosine_kernel_matches_plain(cuda_dev, n, m, d):
    """Ragged n, m and d (one past the 128 x 128 output tile and the 32-wide
    d-chunk; d = 1, 33, 100, 104, 128 and 200; d = 33 and 1 take the 4-byte
    copies) with a zero row on each side: atol 1e-5, and the zero rows'
    cosines exactly 0."""
    from repro_torch.kernels import csls as ck

    g = torch.Generator(device=cuda_dev).manual_seed(n * m + d)
    a = torch.randn(n, d, device=cuda_dev, generator=g)
    b = torch.randn(m, d, device=cuda_dev, generator=g)
    a[n // 2] = 0.0
    b[m - 1] = 0.0
    before = ck.LAUNCHES["cosine_matrix"]
    got = ck.cosine_matrix(a, b)
    want = ck.cosine_matrix_plain(a, b)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cosine_matrix"] == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not bool(got[n // 2].any()) and not bool(got[:, m - 1].any())
    # CSLS adds 2·cos (2e-5) and two top-k means (1e-5 each)
    r_a, r_b = ck.topk_means(want, 10)
    torch.testing.assert_close(ck.csls_matrix(a, b), 2 * want - r_a[:, None] - r_b[None, :],
                               atol=4e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 100])
def test_cosine_kernel_mixed_magnitudes(cuda_dev, d):
    """Rows of magnitude 1e-3 and 1e3 beside zero rows, on both sides:
    cosines do not depend on a row's scale, so the split products must hold
    atol 1e-5 at every scale, and zero rows stay exactly 0."""
    from repro_torch.kernels import csls as ck

    g = torch.Generator(device=cuda_dev).manual_seed(d)
    n, m = 300, 1000
    scale_a = torch.tensor([1e-3, 1.0, 1e3, 0.0], device=cuda_dev).repeat_interleave(n // 4)
    scale_b = torch.tensor([1e3, 0.0, 1e-3, 1.0], device=cuda_dev).repeat_interleave(m // 4)
    a = torch.randn(n, d, device=cuda_dev, generator=g) * scale_a[:, None]
    b = torch.randn(m, d, device=cuda_dev, generator=g) * scale_b[:, None]
    got = ck.cosine_matrix(a, b)
    want = ck.cosine_matrix_plain(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert not bool(got[scale_a == 0].any()) and not bool(got[:, scale_b == 0].any())


@pytest.mark.cuda
def test_cosine_wrapper_raises_on_what_the_kernel_does_not_take(cuda_dev):
    from repro_torch.kernels import csls as ck

    a = torch.zeros(4, 8, device=cuda_dev)
    with pytest.raises(TypeError):
        ck.cosine_matrix(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.cosine_matrix(a, torch.zeros(8, 4, device=cuda_dev).T)
    with pytest.raises(ValueError, match="different devices"):
        ck.cosine_matrix(a, a.cpu())
    with pytest.raises(ValueError, match="expected a"):
        ck.cosine_matrix(a, a[:, :3].contiguous())


@pytest.mark.cuda
def test_blockwise_retrieval_on_the_card(cuda_dev):
    """``csls_argmax`` through the kernel, in 512-row blocks, against the
    materialized plain CSLS matrix: argmaxes equal up to near-ties."""
    from repro_torch.core.alignment import csls_argmax, csls_retrieval_acc
    from repro_torch.kernels import csls as ck

    g = torch.Generator(device=cuda_dev).manual_seed(1)
    x = torch.randn(3000, 64, device=cuda_dev, generator=g)
    q, _ = torch.linalg.qr(torch.randn(64, 64, device=cuda_dev, generator=g))
    y = x @ q + 0.5 * torch.randn(3000, 64, device=cuda_dev, generator=g)
    a = (x @ q).contiguous()
    before = ck.LAUNCHES["cosine_matrix"]
    got = csls_argmax(a, y, block=512)
    assert ck.LAUNCHES["cosine_matrix"] == before + 2 * 6
    full = ck.csls_matrix_ref(a, y)
    want = full.argmax(1)
    rows = torch.arange(3000, device=cuda_dev)
    gap = (full[rows, got] - full[rows, want]).abs()
    assert bool((gap[got != want] <= 1e-5).all())
    assert csls_retrieval_acc(a, y, block=512) > 0.9


@pytest.mark.cuda
def test_ppat_on_the_card_equals_the_cpu(cuda_dev):
    """16 rounds of ``ppat_scan_graph`` on the card and on the CPU from the
    same init and draws: equal vote counts, W within 1e-4."""
    from repro_torch.core import ppat as tp

    cfg = tp.PPATConfig(steps=16)
    d, n = 100, 5000
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n, d, generator=g)
    y = torch.randn(n, d, generator=g)
    init = tp._init_host_params(g, d, cfg)
    draws = tp.draw_ppat(g, cfg, n, n)
    out = {}
    for dev in (torch.device("cpu"), cuda_dev):
        hp = {k: {n_: v.to(dev) for n_, v in p.items()} for k, p in init.items()}
        w = torch.eye(d, device=dev)
        _, w, _, _, n0, n1 = tp.ppat_scan_graph(hp, w, torch.zeros_like(w), x.to(dev),
                                                y.to(dev), n, n, cfg, draws=draws)
        out[dev.type] = (w.cpu(), n0.cpu(), n1.cpu())
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    assert torch.equal(out["cpu"][2], out["cuda"][2])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], atol=1e-4, rtol=0)


# ------------------------------------------------------------- federation
@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["accuracy", "hit10"])
def test_scheduler_on_the_card_equals_the_cpu(cuda_dev, monkeypatch, metric):
    """``FederationScheduler`` over three owners of a small universe on the
    card (epoch kernel, rank kernel) and on the CPU (their plain versions),
    both under ``REPRO_TRAIN_IMPL=fused``, from the same start tables and
    from two ``GeneratorDraws`` of one seed (the same CPU draws in the same
    order): equal events, bit-equal epsilon, tables within 1e-5."""
    from repro_torch.core.federation import FederationScheduler, GeneratorDraws
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import synthesize_universe

    monkeypatch.setenv("REPRO_TRAIN_IMPL", "fused")
    uni = synthesize_universe(seed=1, scale=1 / 500)
    kgs = {n: uni[n] for n in ("Dbpedia", "Yago", "Geonames")}
    cfg = PPATConfig(steps=12, seed=0)
    runs = []
    for dev in (cuda_dev, torch.device("cpu")):
        s = FederationScheduler(kgs, dim=16, ppat_cfg=cfg, local_epochs=2, update_epochs=1,
                                seed=0, score_metric=metric, device=dev,
                                draws=GeneratorDraws(47, cfg, 16))
        g = torch.Generator().manual_seed(53)
        for tr in s.trainers.values():
            tr.params = {k: (torch.rand(v.shape, generator=g) - 0.5).to(dev)
                         for k, v in tr.params.items()}
        s.initial_training()
        s.run(max_ticks=2)
        runs.append(s)
    a, b = runs
    keys = ("tick", "host", "client", "kind", "accepted", "fault", "owner_clock", "view_version")
    assert [[getattr(e, k) for k in keys] for e in a.events] == \
        [[getattr(e, k) for k in keys] for e in b.events]
    assert [repr(e.epsilon) for e in a.events] == [repr(e.epsilon) for e in b.events]
    assert a.accountant.epsilon() == b.accountant.epsilon()
    assert sum(e.kind == "ppat" for e in a.events) == 6
    for n in kgs:
        for k, v in b.trainers[n].params.items():
            torch.testing.assert_close(a.trainers[n].params[k].cpu(), v, atol=1e-5, rtol=0)


def _tick_fed(dev, impl, families=None, **kw):
    """Three owners of the small universe on ``dev`` from fixed start tables
    and a ``GeneratorDraws`` of seed 47, on the tick engine ``impl``."""
    from repro_torch.core.federation import FederationScheduler, GeneratorDraws
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import synthesize_universe

    uni = synthesize_universe(seed=1, scale=1 / 500)
    kgs = {n: uni[n] for n in ("Dbpedia", "Yago", "Geonames")}
    cfg = PPATConfig(steps=12, seed=0)
    s = FederationScheduler(kgs, dim=16, ppat_cfg=cfg, local_epochs=2, update_epochs=1, seed=0,
                            device=dev, draws=GeneratorDraws(47, cfg, 16), tick_impl=impl,
                            families=families, score_metric="hit10", **kw)
    g = torch.Generator().manual_seed(53)
    for tr in s.trainers.values():
        tr.params = {k: (torch.rand(v.shape, generator=g) - 0.5).to(dev)
                     for k, v in tr.params.items()}
    return s


TICK_KEYS = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "owner_clock",
             "view_version", "score_before", "score_after", "epsilon")


def _same_runs(a, b, atol=0.0):
    assert [[repr(getattr(e, k)) for k in TICK_KEYS] for e in a.events] == \
        [[repr(getattr(e, k)) for k in TICK_KEYS] for e in b.events]
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            w = b.trainers[n].params[k].to(v.device)
            if atol:
                torch.testing.assert_close(v, w, atol=atol, rtol=0)
            else:
                assert torch.equal(v, w), f"{n}.{k}"


@pytest.mark.cuda
@pytest.mark.parametrize("families", [None, {"Dbpedia": "transh", "Yago": "transe",
                                             "Geonames": "transd"}], ids=["transe", "mixed"])
def test_batched_on_the_card_equals_serial_on_the_card(cuda_dev, families):
    """Two ticks through the batched engine (captured graphs, the SVD and
    the TransH/D retrains as eager segments) and through the serial engine
    on the card from the same draws: every decision, score and epsilon,
    and every table bit for bit."""
    from repro_torch.core import tick_engine

    tick_engine.clear_tick_programs()
    runs = {}
    for impl in ("reference", "batched"):
        s = _tick_fed(cuda_dev, impl, families)
        s.initial_training()
        s.run(max_ticks=2)
        runs[impl] = s
    _same_runs(runs["reference"], runs["batched"])
    st = runs["batched"]._tick_engine.stats
    assert st["entries"] == 6 and st["captured"] > 0
    assert (st["eager_segments"] > 0) and (families is None or st["eager_segments"] > 6)


@pytest.mark.cuda
def test_a_replay_is_bit_equal_to_the_eager_run(cuda_dev):
    """The first scheduler's entries run eagerly and capture their graphs;
    a second scheduler from the same tables and draws replays every one of
    them: the same events and tables, bit for bit, and no new capture."""
    from repro_torch.core import tick_engine

    tick_engine.clear_tick_programs()
    a = _tick_fed(cuda_dev, "batched")
    a.initial_training()
    a.run(max_ticks=2)
    graphs = tick_engine.tick_graph_stats()["graphs"]
    assert graphs == a._tick_engine.stats["captured"] > 0
    b = _tick_fed(cuda_dev, "batched")
    b.initial_training()
    b.run(max_ticks=2)
    _same_runs(a, b)
    assert b._tick_engine.stats["captured"] == 0
    assert b._tick_engine.stats["replays"] == graphs
    assert tick_engine.tick_graph_stats()["graphs"] == graphs


@pytest.mark.cuda
def test_a_second_tick_replays_without_a_capture(cuda_dev):
    """Four equal-shaped owners: the first handshake captures, the other
    three replay; the next handshake tick captures nothing."""
    from repro_torch.core import tick_engine
    from repro_torch.core.federation import FederationScheduler
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import equal_shape_universe

    tick_engine.clear_tick_programs()
    kgs = equal_shape_universe(4, entities=120, relations=6, triples=800, shared=32, seed=3)
    s = FederationScheduler(kgs, dim=16, ppat_cfg=PPATConfig(steps=8, seed=0), local_epochs=2,
                            update_epochs=1, seed=0, use_virtual=False, score_max_test=24,
                            device=cuda_dev)
    s.initial_training()
    s.best_score = {n: -1.0 for n in kgs}  # every handshake is accepted: offers keep coming
    s.run(max_ticks=1)
    first = dict(s._tick_engine.last)
    assert first["entries"] == 4 and first["captured"] == 2 and first["replays"] == 2 * 3
    s.run(max_ticks=1)
    assert s._tick_engine.last["entries"] == 4 and s._tick_engine.last["captured"] == 0
    assert s._tick_engine.last["replays"] == 2 * 4
    assert tick_engine.tick_program_cache_size() == 1


@pytest.mark.cuda
def test_launch_counters_count_replays(cuda_dev):
    """A replayed tick adds the launches its graphs captured: one epoch
    kernel per retrain epoch and two rank launches per 128 scored triples
    for every entry, as in an eager tick."""
    from repro_torch.core import tick_engine

    tick_engine.clear_tick_programs()
    warm = _tick_fed(cuda_dev, "batched")
    warm.initial_training()
    warm.run(max_ticks=2)
    s = _tick_fed(cuda_dev, "batched")
    s.initial_training()
    STEP_LAUNCHES["sparse_sgd_step"] = LAUNCHES["fused_ranks"] = 0
    s.run(max_ticks=2)
    entries = [e for e in s.events if e.kind != "init"]
    assert s._tick_engine.stats["captured"] == 0 and s._tick_engine.stats["replays"] > 0
    assert STEP_LAUNCHES["sparse_sgd_step"] == len(entries) * s.update_epochs
    want = sum(2 * -(-min(len(s.kgs[e.host].valid), s.score_max_test) // 128) for e in entries)
    assert want > 0 and LAUNCHES["fused_ranks"] == want


@pytest.mark.cuda
def test_a_capture_that_cannot_succeed_raises(cuda_dev, monkeypatch):
    """A stage that reads back to the host cannot be captured: the tick
    raises ``GraphCaptureError`` (nothing runs eagerly in the graph's
    place), no event is recorded, no owner is left busy and the plan's
    offers are back in their queues."""
    from repro_torch.core import tick_engine
    from repro_torch.core.federation import NodeState

    tick_engine.clear_tick_programs()
    strip = tick_engine._STAGES["strip"]

    def syncing(s, spec):
        float(s["padded/ent"].sum())  # a host read: illegal while capturing
        return strip(s, spec)

    monkeypatch.setitem(tick_engine._STAGES, "strip", syncing)
    s = _tick_fed(cuda_dev, "batched")
    s.initial_training()
    queues = {n: sorted(q) for n, q in s.queue.items()}
    n_events = len(s.events)
    with pytest.raises(tick_engine.GraphCaptureError, match="did not capture"):
        s.run(max_ticks=1)
    assert len(s.events) == n_events
    assert all(st is NodeState.READY for st in s.state.values())
    assert {n: sorted(q) for n, q in s.queue.items()} == queues
    tick_engine.clear_tick_programs()


#: the JAX package's resume-test storm (``tests/test_adversary.py``), defended
STORM = dict(tick_adversary="drift=0.4,replay=0.6,seed=2,strength=0.9,frac=0.5",
             robust_agg="median", cos_screen=0.3)
STORM_KEYS = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
              "owner_clock", "view_version")


def _storm_fed(dev, sync="barrier", draws=True, **kw):
    """The small universe's scheduler under the storm on ``dev``, from
    fixed start tables (and a ``GeneratorDraws`` of seed 47)."""
    from repro_torch.core.federation import FederationScheduler, GeneratorDraws
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import synthesize_universe

    uni = synthesize_universe(seed=1, scale=1 / 500)
    kgs = {n: uni[n] for n in ("Dbpedia", "Yago", "Geonames")}
    cfg = PPATConfig(steps=12, seed=0)
    s = FederationScheduler(kgs, dim=16, ppat_cfg=cfg, local_epochs=2, update_epochs=1, seed=0,
                            device=dev, draws=GeneratorDraws(47, cfg, 16) if draws else None,
                            tick_sync=sync, staleness_bound=0, **STORM, **kw)
    g = torch.Generator().manual_seed(53)
    for tr in s.trainers.values():
        tr.params = {k: (torch.rand(v.shape, generator=g) - 0.5).to(dev)
                     for k, v in tr.params.items()}
    return s


def _storm_events(s, after=0):
    return [[getattr(e, k) for k in STORM_KEYS] for e in s.events if e.tick > after]


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["barrier", "stream"])
def test_storm_on_the_card_equals_the_cpu(cuda_dev, monkeypatch, sync):
    """The defended storm (barrier, and streamed with bound 0) on the card
    and on the CPU under ``REPRO_TRAIN_IMPL=fused`` from the same draws:
    equal events (attack, fault, level), reputation and epsilon bit for
    bit, tables within 1e-5."""
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "fused")
    runs = []
    for dev in (cuda_dev, torch.device("cpu")):
        s = _storm_fed(dev, sync)
        s.initial_training()
        s.run(max_ticks=3)
        runs.append(s)
    a, b = runs
    assert _storm_events(a) == _storm_events(b)
    assert any(e.attack for e in a.events)
    assert a._reputation == b._reputation
    assert [repr(e.epsilon) for e in a.events] == [repr(e.epsilon) for e in b.events]
    for n in a.trainers:
        for k, v in b.trainers[n].params.items():
            torch.testing.assert_close(a.trainers[n].params[k].cpu(), v, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_storm_resume_on_the_card_is_bit_equal(cuda_dev, tmp_path):
    """A storm cut after two ticks and resumed on the card, from the
    scheduler's own generators (their CUDA states ride the checkpoint):
    the uninterrupted run's events and tables bit for bit."""
    from repro_torch.checkpoint import restore_scheduler, save_scheduler

    path = str(tmp_path / "storm.npz")
    a = _storm_fed(cuda_dev, draws=False)
    a.initial_training()
    a.run(max_ticks=2)
    save_scheduler(path, a)
    a.run(max_ticks=2)
    b = _storm_fed(cuda_dev, draws=False)
    restore_scheduler(path, b)
    b.run(max_ticks=2)
    assert _storm_events(a, 2) == _storm_events(b)
    assert a._reputation == b._reputation and a.epsilons == b.epsilons
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k}"


@pytest.mark.cuda
def test_card_checkpoint_restores_into_a_cpu_scheduler(cuda_dev, monkeypatch, tmp_path):
    """Saved on the card, restored into a CPU scheduler with the same
    ``GeneratorDraws``: the next tick's events equal the card's; without a
    draw source the card's generator states cannot load and it raises."""
    from repro_torch.checkpoint import restore_scheduler, save_scheduler

    monkeypatch.setenv("REPRO_TRAIN_IMPL", "fused")
    path = str(tmp_path / "card.npz")
    a = _storm_fed(cuda_dev)
    a.initial_training()
    a.run(max_ticks=2)
    save_scheduler(path, a)
    a.run(max_ticks=1)
    c = _storm_fed(torch.device("cpu"))
    restore_scheduler(path, c)
    c.run(max_ticks=1)
    assert _storm_events(c) == _storm_events(a, 2) and _storm_events(c)
    assert c._reputation == a._reputation
    b = _storm_fed(cuda_dev, draws=False)
    b.initial_training()
    save_scheduler(path, b)
    with pytest.raises(ValueError, match="cuda generator states"):
        restore_scheduler(path, _storm_fed(torch.device("cpu"), draws=False))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "clip", "median", "trimmed"])
def test_robust_rows_on_the_card_equal_the_cpu(cuda_dev, mode):
    """``robust_rows`` at the handshake's padded shape on the card and on
    the CPU: ``median`` (and ``none``) bit-equal, ``clip`` and ``trimmed``
    within 1e-6, the mean cosine within 1e-6."""
    from repro_torch.core.aggregation import robust_rows

    g = torch.Generator().manual_seed(3)
    cur = torch.randn(4096, 100, generator=g)
    synth = cur + 0.1 * torch.randn(4096, 100, generator=g)
    synth[5] += 40.0
    want, wcos = robust_rows(cur, synth, 4000, mode=mode, want_cos=True)
    got, gcos = robust_rows(cur.to(cuda_dev), synth.to(cuda_dev), 4000, mode=mode, want_cos=True)
    if mode in ("none", "median"):
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)
    assert abs(float(gcos) - float(wcos)) <= 1e-6


@pytest.mark.cuda
def test_attacks_on_the_card_equal_the_cpu(cuda_dev):
    """The leakage attacks on the card: AUC exactly, the rest within 1e-9."""
    from repro_torch.core import attacks

    rng = np.random.default_rng(0)
    ent = rng.normal(size=(60, 8))
    members = np.array([(i, i % 3, i + 1) for i in range(0, 40, 2)])
    nonmembers = rng.integers(0, 60, size=(25, 3)) % [60, 3, 60]
    rows = {i: ent[i] for i in range(60) if i % 9}
    want = attacks.membership_inference(rows, members, nonmembers, device="cpu")
    got = attacks.membership_inference({k: torch.tensor(v, device=cuda_dev)
                                        for k, v in rows.items()}, members, nonmembers)
    assert got["n_member"] == want["n_member"] and got["n_nonmember"] == want["n_nonmember"]
    assert abs(got["auc"] - want["auc"]) <= 1e-9
    pos, neg = rng.integers(0, 6, 80).astype(float), rng.normal(size=50)
    assert attacks.auc(torch.tensor(pos, device=cuda_dev), torch.tensor(neg)) == \
        attacks.auc(pos, neg, device="cpu")
    true = rng.normal(size=(300, 16))
    rel = true @ np.linalg.qr(rng.normal(size=(16, 16)))[0] + 0.3 * rng.normal(size=(300, 16))
    w = attacks.reconstruction_attack(rel, true, device="cpu")
    c = attacks.reconstruction_attack(torch.tensor(rel, device=cuda_dev), true)
    assert abs(c["cosine"] - w["cosine"]) <= 1e-9 and abs(c["mse"] - w["mse"]) <= 1e-9
    d = attacks.reconstruction_attack(rel, true)  # arrays run on the current card
    assert abs(d["cosine"] - w["cosine"]) <= 1e-9 and abs(d["mse"] - w["mse"]) <= 1e-9
    assert attacks.membership_inference(rows, members, nonmembers)["auc"] == got["auc"]


# ------------------------------------------------------- LM serving kernels
FLASH_CASES = [
    # b, h, kv, s, dh, causal, window
    (1, 16, 8, 1024, 128, True, 0),   # qwen3-0.6b's heads
    (2, 4, 2, 333, 64, True, 0),      # ragged S
    (1, 4, 4, 333, 64, False, 64),    # non-causal with a window
    (1, 8, 2, 200, 32, True, 64),     # GQA 4:1, sliding window, Dh 32
    (1, 2, 1, 1, 128, True, 0),       # one token
    (4, 16, 8, 2048, 128, True, 0),   # the serve script's batch 4 x 2,048
    (1, 16, 8, 2049, 128, True, 0),   # one past the 64-row tiles
    (1, 64, 8, 1024, 112, True, 0),   # kimi-k2-1t's heads: Dh 112
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,dh,causal,window", FLASH_CASES)
def test_flash_attention_matches_plain(cuda_dev, b, h, kv, s, dh, causal, window, dtype):
    """The kernel on the model's (B, S, H, Dh) projections seen as (B, H, S,
    Dh) views, against the dense plain version on the same inputs: within
    1e-5 (atol and rtol) at fp32; at bf16 both round the same fp32 result,
    so they differ by at most one bf16 ulp (rtol 2**-7, atol 1e-5)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_dev).manual_seed(s * h + dh)
    q = torch.randn(b, s, h, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, s, kv, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,t,dh", [(2, 16, 16, 333, 1500, 64),    # whisper's cross
                                           (1, 8, 2, 1000, 77, 112)])
def test_flash_attention_cross_s_not_t(cuda_dev, b, h, kv, s, t, dh, dtype):
    """Non-causal attention of S queries over T ≠ S keys (the decoder's
    cross-attention over the encoder's frames) against the plain version,
    with the tolerances of ``test_flash_attention_matches_plain``."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_dev).manual_seed(s + t)
    q = torch.randn(b, s, h, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    k = torch.randn(b, t, kv, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    v = torch.randn(b, t, kv, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,dh,causal", [(1, 16, 8, 1024, 128, True),
                                                (1, 4, 2, 333, 64, False)])
def test_flash_attention_large_scores(cuda_dev, b, h, kv, s, dh, causal, dtype):
    """Scores of magnitude ~50-60 (q and k 3.5 N(0, 1), as with qk-norm off).
    There the rounding of a score in fp32, amplified by exp, moves the output
    by more than 1e-5: the fp32 plain version (cuBLAS) is itself that far
    from a float64 truth, so no fp32 result holds 1e-5 there.
    At fp32 the kernel is held to fp32's own accuracy: within twice the plain
    version's largest distance from the float64 truth. At bf16, within one
    bf16 ulp of the plain version, as above."""
    from _torch_lm_check import attention_f64
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_dev).manual_seed(s + dh)
    q = (3.5 * torch.randn(b, s, h, dh, device=cuda_dev, generator=g)).to(dtype).transpose(1, 2)
    k = (3.5 * torch.randn(b, s, kv, dh, device=cuda_dev, generator=g)).to(dtype).transpose(1, 2)
    v = torch.randn(b, s, kv, dh, device=cuda_dev, generator=g).to(dtype).transpose(1, 2)
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        truth = attention_f64(q, k, v, causal=causal)
        plain_err = float((fa.attention_ref(q, k, v, causal=causal).double() - truth).abs().max())
        err = float((got.double() - truth).abs().max())
        assert err <= 2 * plain_err, (err, plain_err)
    else:
        torch.testing.assert_close(got.float(), fa.attention_ref(q, k, v, causal=causal).float(),
                                   atol=1e-5, rtol=2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flash_attention_unaligned_views(cuda_dev, dtype):
    """q, k, v as views one element past a 16-byte boundary (and v with an odd
    row stride): the wrapper copies what the kernel's 16-byte copies cannot
    read in place, and the result is the plain version's."""
    from repro_torch.kernels import flash_attention as fa

    b, h, kv, s, dh = 1, 4, 2, 100, 64
    g = torch.Generator(device=cuda_dev).manual_seed(5)

    def view(heads, row):
        flat = torch.randn(1 + b * s * row, device=cuda_dev, generator=g).to(dtype)
        return flat[1:].view(b, s, row)[..., :heads * dh].reshape(b, s, heads, dh).transpose(1, 2)

    q, k, v = view(h, h * dh), view(kv, kv * dh), view(kv, kv * dh + 1)
    assert q.data_ptr() % 16 and v.stride(2) % 2
    got = fa.flash_attention(q, k, v)
    want = fa.attention_ref(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda_dev):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 2, 8, 48, device=cuda_dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 64, device=cuda_dev)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, torch.zeros(1, 2, 64, 8, device=cuda_dev).transpose(2, 3), q)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q, torch.zeros(1, 3, 8, 64, device=cuda_dev),
                           torch.zeros(1, 3, 8, 64, device=cuda_dev))


def _ssd_inputs(g, dev, b, s, h, p, n):
    """Inputs with the Mamba2 laws of ``Mamba2Mixer``: A = −(1..H), dt =
    softplus(N(0, 1) + softplus⁻¹(dt_init)), log dt_init uniform on
    [log 1e-3, log 1e-1]."""
    import math

    x = torch.randn(b, s, h, p, device=dev, generator=g)
    u = torch.rand(h, device=dev, generator=g)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=dev, generator=g)
                                      + torch.log(torch.expm1(dt_init)))
    a = -torch.arange(1, h + 1, device=dev, dtype=torch.float32)
    bm = torch.randn(b, s, 1, n, device=dev, generator=g)
    cm = torch.randn(b, s, 1, n, device=dev, generator=g)
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 512, 80, 64, 128, 256),   # mamba2-2.7b's heads, two chunks
    (2, 96, 16, 32, 32, 32),      # the reduced card
    (1, 150, 3, 16, 8, 50),       # a chunk that is not a multiple of the 64-row tile
    (1, 64, 2, 128, 72, 64),      # P 128, N past one 64-wide tile
    (1, 384, 6, 64, 128, 192),    # Q 192: three 64-row tiles
    (1, 2048, 4, 64, 128, 1024),  # Q 1,024: four 256-column bands of S per late tile
    (4, 512, 80, 64, 128, 256),   # the serve script's batch of 4
    (1, 256, 5, 16, 64, 256),     # P 16 at a full chunk
    (2, 512, 12, 128, 128, 256),  # P 128 at a full chunk
])
def test_ssd_chunks_match_plain(cuda_dev, b, s, h, p, n, chunk):
    """The chunk kernel against its plain version on the card (all three
    outputs), and the whole SSD against the plain chunk loop
    (``models.ssm.ssd``), with and without an initial state. The kernel and
    the plain version sum ``cum`` in the same order, so the outputs agree
    within 1e-5 of their largest magnitude; the whole SSD, whose plain loop
    takes ``torch.cumsum``, within 1e-3 of it."""
    from repro_torch.kernels import ssd_scan as ks

    g = torch.Generator(device=cuda_dev).manual_seed(s * h + p)
    x, dt, a, bm, cm = _ssd_inputs(g, cuda_dev, b, s, h, p, n)
    nc, q = s // chunk, chunk
    xg = x.reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dtg = dt.reshape(b, nc, q, h).permute(0, 3, 1, 2)
    bg, cg = bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n)
    before = ks.LAUNCHES["ssd_chunks"]
    got = ks.ssd_chunks(xg, dtg, a, bg, cg)
    want = ks.ssd_chunks_plain(xg, dtg, a, bg, cg)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["ssd_chunks"] == before + 1
    for name, x_, y_ in zip(("y_intra", "state", "decay"), got, want):
        err = float((x_ - y_).abs().max())
        assert err <= 1e-5 * float(y_.abs().max()), (name, err, float(y_.abs().max()))
    s0 = torch.randn(b, h, p, n, device=cuda_dev, generator=g)
    for state in (None, s0):
        y, fin = ks.ssd_chunk_kernel_apply(x, dt, a, bm, cm, chunk=chunk, state=state)
        yr, fr = ks.ssd_ref(x, dt, a, bm, cm, chunk, state)
        assert float((y - yr).abs().max()) <= 1e-3 * float(yr.abs().max())
        assert float((fin - fr).abs().max()) <= 1e-3 * float(fr.abs().max())


@pytest.mark.cuda
def test_shared_memory_sizes_in_python_equal_the_kernels(cuda_dev):
    """The wrappers size shared memory (and choose layouts and head groups)
    from Python copies of the kernels' own layouts: they must agree."""
    import ctypes

    from repro_torch.kernels.sparse_update import ops as sops
    from repro_torch.kernels.ssd_scan import ops as kops

    sp = sops.STEP_LIB.load().sparse_update_smem_bytes
    sp.restype = ctypes.c_longlong
    for b, d in [(100, 100), (544, 100), (576, 100), (1056, 33), (1, 1)]:
        assert sp(b, d) == sops.smem_bytes(b, d)
    sd = kops.SSD_LIB.load().ssd_chunks_smem_bytes
    sd.restype = ctypes.c_longlong
    for p in kops.HEAD_DIMS:
        for g, q in [(1, 4096), (5, 256), (20, 256), (3, 50)]:
            assert sd(p, g, q) == kops.smem_bytes(p, g, q)


def _ssd_check(ks, args):
    got = ks.ssd_chunks(*args)
    want = ks.ssd_chunks_plain(*args)
    torch.cuda.synchronize()
    for name, x_, y_ in zip(("y_intra", "state", "decay"), got, want):
        assert x_.shape == y_.shape, name
        err = float((x_ - y_).abs().max())
        assert err <= 1e-5 * float(y_.abs().max()), (name, err, float(y_.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,nc,group", [(1, 7, 2, None), (2, 7, 16, 2), (4, 5, 16, 3),
                                         (4, 7, 16, 4)])
def test_ssd_chunks_head_groups(cuda_dev, b, h, nc, group):
    """Shapes on which the wrapper (on the H100's 132 SMs) puts H heads in
    blocks of G that do not divide them, so the last block's group is
    shorter, and a small one of its own choice: within 1e-5 of the plain
    version's largest magnitude, on every output."""
    from repro_torch.kernels import ssd_scan as ks

    g = torch.Generator(device=cuda_dev).manual_seed(77)
    p, n, chunk = 64, 128, 256
    s = nc * chunk
    if group is not None:
        sms = torch.cuda.get_device_properties(cuda_dev).multi_processor_count
        assert ks.ops.head_group(b, h, nc, chunk, p, n, sms) == group and h % group
    x, dt, a, bm, cm = _ssd_inputs(g, cuda_dev, b, s, h, p, n)
    args = (x.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4),
            dt.reshape(b, nc, chunk, h).permute(0, 3, 1, 2), a,
            bm.reshape(b, nc, chunk, n), cm.reshape(b, nc, chunk, n))
    _ssd_check(ks, args)


@pytest.mark.cuda
def test_ssd_chunks_unaligned_views(cuda_dev):
    """x, B and C whose pointers are off 16 bytes, and B and C rows of N = 6
    (not a multiple of 4): the wrapper copies what the 16-byte copies cannot
    read, and the outputs keep their shapes and 1e-5."""
    from repro_torch.kernels import ssd_scan as ks

    g = torch.Generator(device=cuda_dev).manual_seed(78)
    b, nc, q, h, p, n = 2, 2, 96, 3, 32, 6

    def off(*shape):
        flat = torch.randn(1 + int(np.prod(shape)), device=cuda_dev, generator=g)
        return flat[1:].view(*shape)

    x = off(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    dt = torch.nn.functional.softplus(off(b, nc, q, h)).permute(0, 3, 1, 2) * 0.1
    a = -torch.arange(1, h + 1, device=cuda_dev, dtype=torch.float32)
    bm, cm = off(b, nc, q, n), off(b, nc, q, n)
    assert x.data_ptr() % 16 and bm.data_ptr() % 16 and n % 4
    _ssd_check(ks, (x, dt, a, bm, cm))


@pytest.mark.cuda
def test_ssd_wrapper_raises_on_what_the_kernel_does_not_take(cuda_dev):
    from repro_torch.kernels import ssd_scan as ks

    x = torch.zeros(1, 2, 1, 8, 48, device=cuda_dev)
    dt = torch.zeros(1, 2, 1, 8, device=cuda_dev)
    a = torch.zeros(2, device=cuda_dev)
    bc = torch.zeros(1, 1, 8, 16, device=cuda_dev)
    with pytest.raises(ValueError, match="head dim"):
        ks.ssd_chunks(x, dt, a, bc, bc)
    with pytest.raises(TypeError):
        ks.ssd_chunks(x[..., :32].double(), dt, a, bc, bc)
    with pytest.raises(NotImplementedError, match="one group"):
        ks.ssd_chunk_kernel_apply(torch.zeros(1, 8, 2, 32, device=cuda_dev),
                                  torch.zeros(1, 8, 2, device=cuda_dev), a,
                                  torch.zeros(1, 8, 2, 16, device=cuda_dev),
                                  torch.zeros(1, 8, 2, 16, device=cuda_dev))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "kimi-k2-1t-a32b", "internvl2-26b"])
def test_lm_engine_on_the_card_equals_the_cpu(cuda_dev, arch):
    """The reduced card served by ``ServingEngine`` on the card (kernels) and
    on the CPU (plain versions), same weights and ragged prompts: tokens
    equal up to near-ties (1e-4 of the CPU's logits), and the card's run
    launched its kernels in every prefill, once per attention (SSM) layer.
    The VLM card gets a slot per request: a recycled VLM slot attends its
    previous request's rows, which no batch-1 run has."""
    from _torch_lm_check import assert_tokens_match, batch1_greedy
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models import init_params
    from repro_torch.models.blocks import layer_kinds
    from repro_torch.serving import ServingEngine

    cfg = reduced(get_config(arch)).replace(dtype="float32")
    kinds = layer_kinds(cfg)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda_dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 37, 64, 20, 90)]
    fa.reset_launches()
    ks.reset_launches()
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda_dev)):
        eng = ServingEngine(model, cfg, max_batch=len(prompts) if cfg.num_patches else 2,
                            max_len=128, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        out[name] = {r.rid: r.generated for r in eng.run_until_drained()}
    assert fa.LAUNCHES["flash_attention"] == len(prompts) * sum(k.mixer == "attn" for k in kinds)
    assert ks.LAUNCHES["ssd_chunks"] == len(prompts) * sum(k.mixer == "ssm" for k in kinds)
    for rid, p in enumerate(prompts):
        ref, logits = batch1_greedy(cpu, p, 12, offset=cfg.num_patches)
        assert_tokens_match(out["cpu"][rid], ref, logits, 1e-4)
        assert_tokens_match(out["card"][rid], ref, logits, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b", "mixtral-8x22b"])
def test_lm_serve_on_the_card_equals_the_cpu(cuda_dev, arch):
    """``launch/serve.generate`` of the reduced card with seeded frames or
    patches on the card (kernels: the encoder, self- and cross-attention)
    and on the CPU, same weights: logits of the batched prefill within
    1e-4, tokens equal up to near-ties of the CPU's batch-1 logits (row 0;
    MoE rows are coupled through capacity, so there the CPU's batched
    tokens are the reference and the first tokens are compared)."""
    from _torch_lm_check import assert_tokens_match, batch1_greedy
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = reduced(get_config(arch)).replace(dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda_dev)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    inputs = {}
    if cfg.encoder_layers:
        inputs["frames"] = torch.randn(3, cfg.encoder_seq, cfg.d_model,
                                       generator=torch.Generator().manual_seed(3))
    if cfg.num_patches:
        inputs["patches"] = torch.randn(3, cfg.num_patches, cfg.d_model,
                                        generator=torch.Generator().manual_seed(4))
    on_card = {k: v.to(cuda_dev) for k, v in inputs.items()}
    rows = 40 + cfg.num_patches
    want = cpu.prefill(torch.from_numpy(prompts).long(), cpu.init_cache(3, rows), **inputs)
    fa.reset_launches()
    got = card.prefill(torch.from_numpy(prompts).long().to(cuda_dev), card.init_cache(3, rows),
                       **on_card)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == cfg.encoder_layers + cfg.num_layers * (
        2 if cfg.encoder_layers else 1)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    toks_cpu, _ = serve.generate(cpu, prompts, 8, **inputs)
    toks_card, _ = serve.generate(card, prompts, 8, **on_card)
    if cfg.moe.enabled:
        assert (toks_card[:, 0] == toks_cpu[:, 0]).all()
        return
    ref, logits = batch1_greedy(cpu, prompts[0], 8, offset=cfg.num_patches,
                                **{k: v[:1] for k, v in inputs.items()})
    assert_tokens_match(toks_cpu[0], ref, logits, 1e-4)
    assert_tokens_match(toks_card[0], ref, logits, 1e-4)


@pytest.mark.cuda
def test_party_exchange_on_the_card_equals_the_in_process_handshake(cuda_dev, tmp_path):
    """Two ranks over gloo, both on the card (the pipe staged through pinned
    host memory), against ``PPATClient`` and ``PPATHost.step`` in this
    process on the card from the same draws: W, the discriminators, the
    per-round vote counts and epsilon bit-equal; two (B, d) tensors a
    round on the pipe."""
    from repro_torch.core import parties
    from repro_torch.core.pate import laplace_noise
    from repro_torch.core.ppat import PPATClient, PPATConfig, PPATHost

    cfg = PPATConfig(steps=16, seed=3)
    n, d = 500, 100
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = (x @ np.linalg.qr(rng.standard_normal((d, d)))[0]).astype(np.float32)
    init = parties.init_distributed_ppat(torch.Generator().manual_seed(11), d, cfg)
    noise = laplace_noise(torch.Generator().manual_seed(12), (cfg.steps, 2, cfg.batch))
    xi, yi = np.random.default_rng(cfg.seed + 29), np.random.default_rng(cfg.seed + 17)
    xbs = np.stack([x[xi.integers(0, n, cfg.batch)] for _ in range(cfg.steps)])
    ybs = np.stack([y[yi.integers(0, n, cfg.batch)] for _ in range(cfg.steps)])
    client, host = parties.run_parties(parties.exchange_party, 2, cfg, init, xbs, ybs, noise,
                                       backend="gloo", init_method=f"file://{tmp_path}/rdzv")

    ppat_client = PPATClient(d, torch.from_numpy(x).to(cuda_dev), cfg)
    ppat_host = PPATHost(None, d, torch.from_numpy(y).to(cuda_dev), cfg,
                         params={k: {n_: v.to(cuda_dev) for n_, v in init[k].items()}
                                 for k in parties.HOST_KEYS})
    votes = []
    update = ppat_host.accountant.update
    ppat_host.accountant.update = lambda n0, n1: (votes.append((n0, n1)), update(n0, n1))
    for s in range(cfg.steps):
        xb, adv = ppat_client.sample_batch()
        grad, _ = ppat_host.step(adv, noise[s])
        ppat_client.apply_grad(xb, grad)
    assert np.array_equal(client["state"]["w"], ppat_client.w.cpu().numpy())
    assert np.array_equal(client["state"]["w_vel"], ppat_client.vel.cpu().numpy())
    for k in parties.HOST_KEYS:
        for leaf, v in ppat_host.params[k].items():
            assert np.array_equal(host["state"][k][leaf], v.cpu().numpy()), (k, leaf)
    assert np.array_equal(host["history"]["n0"], np.stack([v[0] for v in votes]))
    assert np.array_equal(host["history"]["n1"], np.stack([v[1] for v in votes]))
    for side in (client, host):
        assert side["traffic"]["shapes"] == {f"float32[{cfg.batch}, {d}]": cfg.steps}


@pytest.mark.cuda
def test_sharded_step_on_the_card_world2_equals_world1(cuda_dev, tmp_path):
    """The row-sharded step at world 2 (two ranks sharing the card over
    gloo) against world 1 in this process, from the same tables and
    batches: tables within 1e-5 after 50 steps, losses within 1e-6."""
    from repro_torch.core import parties

    e, r, d, b, steps = 10_000, 50, 100, 128, 50
    rng = np.random.default_rng(0)
    params = {"ent": rng.uniform(-0.6, 0.6, (e, d)).astype(np.float32),
              "rel": rng.uniform(-0.6, 0.6, (r, d)).astype(np.float32)}
    pos = np.stack([rng.integers(0, [e, r, e], (b, 3)) for _ in range(steps)])
    neg = pos.copy()
    neg[:, :, 2] = rng.integers(0, e, (steps, b))
    for family in ("transe", "distmult"):
        model = KGEModel(family, e, r, d, margin=2.0)
        two = parties.run_parties(parties.sharded_party, 2, model, 0.3, params, pos, neg,
                                  backend="gloo", init_method=f"file://{tmp_path}/{family}")
        one = parties.sharded_party(parties.make_party_group(0, 1, backend="gloo",
                                                             device=cuda_dev),
                                    model, 0.3, params, pos, neg)
        for k in ("ent", "rel"):
            np.testing.assert_allclose(two[0]["params"][k], one["params"][k].cpu().numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{family}.{k}")
        np.testing.assert_allclose(two[0]["losses"], one["losses"].cpu().numpy(),
                                   rtol=0, atol=1e-6)
        assert np.isfinite(two[0]["losses"]).all()


# ------------------------------------------------------- LM training
FLASH_GRAD_CASES = [
    # b, h, kv, s, dh, causal, window
    (2, 16, 8, 256, 128, True, 0),    # qwen3-0.6b's heads
    (1, 8, 2, 300, 64, True, 64),     # GQA 4:1, a window, ragged S
    (2, 4, 4, 200, 64, False, 0),     # non-causal (whisper's encoder)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,dh,causal,window", FLASH_GRAD_CASES)
def test_flash_attention_gradient_equals_the_plain_path(cuda_dev, b, h, kv, s, dh, causal,
                                                        window, dtype):
    """Under grad the kernel's output carries a ``grad_fn`` (the kernel
    launches once, the backward recomputes the plain version), and the
    gradients of a loss that depends on the output nonlinearly equal the
    plain path's ``torch.autograd.grad``: within 1e-4 of each gradient's
    largest magnitude at fp32 (the forward outputs differ by ~1e-6, which
    the square carries into the gradient); at bf16 within one bf16 ulp of
    it (rtol 2**-7, atol 2**-7 of the largest)."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda_dev).manual_seed(s + dh)
    q, k, v = (torch.randn(b, s, n, dh, device=cuda_dev, generator=g).to(dtype)
               .transpose(1, 2).requires_grad_() for n in (h, kv, kv))
    w = torch.randn(b, h, s, dh, device=cuda_dev, generator=g)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None and fa.LAUNCHES["flash_attention"] == before + 1
    got = torch.autograd.grad((out.float().square() * w).sum(), (q, k, v))
    assert fa.LAUNCHES["flash_attention"] == before + 1     # the backward is plain
    ref = fa.attention_ref(q, k, v, causal=causal, window=window)
    want = torch.autograd.grad((ref.float().square() * w).sum(), (q, k, v))
    for a, e in zip(got, want):
        assert a.dtype == dtype and a.shape == e.shape
        scale = float(e.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(a.float(), e.float(), atol=tol * scale, rtol=tol)


@pytest.mark.cuda
def test_kernels_without_grad_launch_as_before(cuda_dev):
    """Under ``torch.no_grad()``, or with inputs that need no grad, both LM
    kernels launch once per call, give the grad-mode output bit for bit and
    build no graph."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks

    g = torch.Generator(device=cuda_dev).manual_seed(5)
    q, k, v = (torch.randn(1, 128, n, 64, device=cuda_dev, generator=g).transpose(1, 2)
               for n in (8, 2, 2))
    with_grad = fa.flash_attention(*(t.detach().requires_grad_() for t in (q, k, v)))
    before = fa.LAUNCHES["flash_attention"]
    with torch.no_grad():
        a = fa.flash_attention(*(t.detach().requires_grad_() for t in (q, k, v)))
    b = fa.flash_attention(q, k, v)
    assert fa.LAUNCHES["flash_attention"] == before + 2
    assert a.grad_fn is None and b.grad_fn is None and with_grad.grad_fn is not None
    assert torch.equal(a, with_grad.detach()) and torch.equal(b, a)
    x = torch.randn(1, 64, 4, 16, device=cuda_dev, generator=g)
    dt = torch.rand(1, 64, 4, device=cuda_dev, generator=g) * 0.1
    a_ = -torch.arange(1, 5, device=cuda_dev, dtype=torch.float32)
    bm, cm = (torch.randn(1, 64, 1, 8, device=cuda_dev, generator=g) for _ in range(2))
    grad_y, _ = ks.ssd_chunk_kernel_apply(x.requires_grad_(), dt, a_, bm, cm, chunk=32)
    before = ks.LAUNCHES["ssd_chunks"]
    with torch.no_grad():
        y, _ = ks.ssd_chunk_kernel_apply(x, dt, a_, bm, cm, chunk=32)
    assert ks.LAUNCHES["ssd_chunks"] == before + 1 and y.grad_fn is None
    assert grad_y.grad_fn is not None and torch.equal(y, grad_y.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("with_state", [False, True], ids=["no-state", "state"])
def test_ssd_gradient_equals_the_plain_path(cuda_dev, monkeypatch, with_state):
    """The whole SSD through the chunk kernel under grad, against the same
    SSD with the plain chunk version: the gradients of x, dt, A, B, C (and
    the initial state) of a loss over y and the final state agree within
    1e-4 of each gradient's largest magnitude."""
    from repro_torch.kernels.ssd_scan import ops as sops

    g = torch.Generator(device=cuda_dev).manual_seed(11)
    b, s, h, p, n, chunk = 2, 128, 6, 32, 16, 32
    x = torch.randn(b, s, h, p, device=cuda_dev, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, device=cuda_dev, generator=g) - 3)
    a = -torch.arange(1, h + 1, device=cuda_dev, dtype=torch.float32)
    bm, cm = (torch.randn(b, s, 1, n, device=cuda_dev, generator=g) for _ in range(2))
    state = torch.randn(b, h, p, n, device=cuda_dev, generator=g) if with_state else None
    w1 = torch.randn(b, s, h, p, device=cuda_dev, generator=g)
    w2 = torch.randn(b, h, p, n, device=cuda_dev, generator=g)

    def run():
        ins = [t.detach().clone().requires_grad_() for t in (x, dt, a, bm, cm)]
        st = state.detach().clone().requires_grad_() if with_state else None
        y, fin = sops.ssd_chunk_kernel_apply(*ins, chunk=chunk, state=st)
        grads = torch.autograd.grad((y * w1).sum() + (fin * w2).sum(),
                                    ins + ([st] if with_state else []))
        return y, grads

    before = sops.LAUNCHES["ssd_chunks"]
    y, got = run()
    assert y.grad_fn is not None and sops.LAUNCHES["ssd_chunks"] == before + 1
    monkeypatch.setattr(sops, "ssd_chunks", sops.ssd_chunks_plain)
    _, want = run()
    assert sops.LAUNCHES["ssd_chunks"] == before + 1
    for name, a_, e in zip(("x", "dt", "A", "B", "C", "state"), got, want):
        scale = float(e.abs().max())
        torch.testing.assert_close(a_, e, atol=1e-4 * scale, rtol=1e-4, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,mb", [("qwen3-0.6b", 2), ("mamba2-2.7b", 1),
                                     ("whisper-medium", 1), ("jamba-1.5-large-398b", 2)])
def test_train_step_on_the_card_equals_the_cpu(cuda_dev, arch, mb):
    """Two steps of ``make_train_step`` of the reduced card (remat on) on the
    card (kernels forward, plain backward) and on the CPU (plain), same
    weights and batches: metrics within rtol 1e-4, each parameter leaf's
    displacement within 5e-3 of the CPU's (Frobenius; Adam's first step
    is ill-conditioned where |g| is near eps, see tests/test_torch_train.py),
    and the kernels launched twice per attention (SSM) layer and microbatch
    (the forward and remat's recompute), never in the backward."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.launch.train import batches, to_device
    from repro_torch.models.blocks import layer_kinds
    from repro_torch.train import init_train_state, make_train_step

    cfg = reduced(get_config(arch)).replace(dtype="float32")
    assert cfg.remat
    tcfg = TrainConfig(global_batch=4, seq_len=64, microbatches=mb, ce_chunk=32,
                       learning_rate=3e-3, warmup_steps=1, total_steps=2)
    cpu = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    card = init_train_state(torch.Generator().manual_seed(0), cfg, device="cpu")
    card.model.to(cuda_dev)
    card = card._replace(opt=card.opt._replace(
        mu={k: t.to(cuda_dev) for k, t in card.opt.mu.items()},
        nu={k: t.to(cuda_dev) for k, t in card.opt.nu.items()}))
    start = {k: t.detach().clone() for k, t in cpu.model.state_dict().items()}
    step = make_train_step(cfg, tcfg)
    kinds = layer_kinds(cfg)
    attn = sum(k.mixer == "attn" for k in kinds) * (2 if cfg.encoder_layers else 1) \
        + cfg.encoder_layers
    ssm = sum(k.mixer == "ssm" for k in kinds)
    for b in batches(cfg, batch=4, seq_len=64, steps=2, seed=1):
        cpu, mc = step(cpu, to_device(b, cfg, torch.device("cpu")))
        fa.reset_launches()
        ks.reset_launches()
        card, md = step(card, to_device(b, cfg, cuda_dev))
        torch.cuda.synchronize()
        assert fa.LAUNCHES["flash_attention"] == 2 * mb * attn
        assert ks.LAUNCHES["ssd_chunks"] == 2 * mb * ssm
        for k in ("nll", "aux", "z", "loss", "lr"):
            np.testing.assert_allclose(float(md[k]), float(mc[k]), rtol=1e-4, atol=1e-7)
    got = card.model.state_dict()
    for k, p in cpu.model.state_dict().items():
        dw = p - start[k]
        assert float((got[k].cpu() - start[k] - dw).norm()) <= 5e-3 * float(dw.norm()), k


#: the all-to-all MoE against the gather path in bf16: relative to the
#: largest |value|, as chip_smoke.py phase 21b holds them
EP_TOL = 2.0 ** -6


def _ep_case(route_groups):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("kimi-k2-1t-a32b")
    moe = dataclasses.replace(cfg.moe, num_experts=32, experts_per_token=4, d_ff=128,
                              route_groups=route_groups, capacity_factor=16.0)
    return cfg.replace(d_model=256, moe=moe)


def _ep_blocks(name, results, world):
    """A gradient from 4 ranks of a (4, 1) mesh: the router's shares summed,
    the shared expert's shares summed, the experts' blocks concatenated."""
    g = [r["grads"][name] for r in sorted(results, key=lambda r: r["coord"])]
    if name == "router" or name.startswith("shared"):
        return sum(g)
    return np.concatenate(g)


@pytest.mark.cuda
@pytest.mark.parametrize("route_groups", [2, 4], ids=["grouped", "plain"])
def test_expert_parallel_moe_on_the_card_equals_the_gather_path(cuda_dev, tmp_path,
                                                                 route_groups):
    """kimi's MoE layer, narrowed (d 256, 32 experts top-4, d_ff 128, a
    shared expert), bf16, over 4 gloo ranks sharing the card at a capacity
    where nothing drops: the outputs and the gradients of ``sum(y²) + aux``
    (the experts', router's and shared expert's) against the one-process
    gather path on the same routing (``MoE.node_limited``; route groups 2
    takes the grouped branch, 4 the plain one)."""
    from _torch_ranks import moe_rank
    from repro_torch.core import parties
    from repro_torch.models.moe import MoE

    world = 4
    cfg = _ep_case(route_groups)
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    params = {"router": rng.normal(size=(d, e)) / d ** 0.5,
              "w_gate": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_up": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_down": rng.normal(size=(e, f, d)) / f ** 0.5,
              "shared_gate": rng.normal(size=(1, d, f)) / d ** 0.5,
              "shared_up": rng.normal(size=(1, d, f)) / d ** 0.5,
              "shared_down": rng.normal(size=(1, f, d)) / f ** 0.5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(world * 64, 1, d)).astype(np.float32)
    res = parties.run_parties(moe_rank, world, (world, 1), [cfg], params, x, "bfloat16",
                              backend="gloo", init_method=f"file://{tmp_path}/rdzv")
    res = [r[0] for r in res]
    for r in res:
        assert r["stats"]["dropped1"] == r["stats"]["dropped2"] == 0
    moe = MoE(cfg, device=cuda_dev, dtype=torch.bfloat16)
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xb = torch.from_numpy(x).to(cuda_dev, torch.bfloat16)
    y, keep = moe.node_limited(xb, world, x.shape[0])
    assert bool(keep.all())
    named = moe.params()
    grads = torch.autograd.grad((y.float() ** 2).sum(), list(named.values()))
    got = np.concatenate([r["y"] for r in sorted(res, key=lambda r: r["coord"])])
    want = y.detach().float().cpu().numpy()
    assert np.abs(got - want).max() <= EP_TOL * np.abs(want).max()
    for name, g in zip(named, grads):
        if name == "router":
            continue  # the ranks' loss adds the aux, whose router gradient the gather path lacks
        want = g.float().cpu().numpy()
        err = np.abs(_ep_blocks(name, res, world) - want).max() / np.abs(want).max()
        assert err <= EP_TOL, (name, err)
