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
)
from repro_torch.kge.models import KGEModel, params_from_numpy
from repro_torch.serving import KGECandidateRanker, KGEServingTier


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
    assert LAUNCHES["pairwise_scores"] > before["pairwise_scores"]
    q = known[:16]
    on_card, on_cpu = (KGECandidateRanker(t._active.params, m, known)
                       .rank_tails(q[:, 0], q[:, 1], q[:, 2]) for t in tiers)
    np.testing.assert_array_equal(on_card, on_cpu)


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
