"""Port parity: ``repro_torch.kge.data`` is bit-equal to the JAX package's
``kge.data`` for the same seed."""
import numpy as np
import pytest

from repro.kge import data as jdata
from repro_torch.kge import data as tdata

STATS = [("A", 10, 80000, 280000), ("B", 8, 60000, 200000), ("C", 60, 20000, 90000)]
ALIGNS = [("A", "B", 20000), ("B", "C", 4000)]


def _assert_kgs_equal(a, b):
    assert list(a) == list(b)
    for name in a:
        x, y = a[name], b[name]
        assert (x.name, x.num_entities, x.num_relations) == \
            (y.name, y.num_entities, y.num_relations)
        for field in ("triples", "universe_ids", "train", "valid", "test"):
            gx, gy = getattr(x, field), getattr(y, field)
            assert gx.dtype == gy.dtype, field
            np.testing.assert_array_equal(gx, gy, err_msg=field)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_universe_bit_equal(seed):
    kw = dict(seed=seed, scale=1 / 400, kg_stats=STATS, alignments=ALIGNS)
    _assert_kgs_equal(jdata.synthesize_universe(**kw), tdata.synthesize_universe(**kw))


@pytest.mark.parametrize("n_owners,seed", [(3, 0), (5, 11)])
def test_equal_shape_universe_bit_equal(n_owners, seed):
    kw = dict(entities=60, relations=4, triples=300, shared=12, seed=seed)
    _assert_kgs_equal(jdata.equal_shape_universe(n_owners, **kw),
                      tdata.equal_shape_universe(n_owners, **kw))


def test_aligned_with_and_corrupt_triples_bit_equal():
    kw = dict(seed=1, scale=1 / 400, kg_stats=STATS, alignments=ALIGNS)
    ja, ta = jdata.synthesize_universe(**kw), tdata.synthesize_universe(**kw)
    for x, y in (("A", "B"), ("B", "C")):
        for got, want in zip(ta[x].aligned_with(ta[y]), ja[x].aligned_with(ja[y])):
            np.testing.assert_array_equal(got, want)
    tri = ja["A"].test
    np.testing.assert_array_equal(
        tdata.corrupt_triples(np.random.default_rng(5), tri, ja["A"].num_entities),
        jdata.corrupt_triples(np.random.default_rng(5), tri, ja["A"].num_entities),
    )
    assert tdata.PAPER_KG_STATS == jdata.PAPER_KG_STATS
    assert tdata.PAPER_ALIGNMENTS == jdata.PAPER_ALIGNMENTS
