"""Port parity: ``repro_torch.core.aggregation`` (and ``procrustes``)
against the JAX package's, on KGs from ``synthesize_universe`` (bit-equal in
both packages) and trainers started from the same tables.

``neighbor_structure`` and ``virtual_structure`` are integer bookkeeping and
must be equal exactly, including the ``max_neighbors`` cut (the port scans
membership with ``np.isin`` but keeps the JAX row order). Table updates are
one float32 average or copy, so they are equal exactly too; ``procrustes``
goes through an SVD in each framework and agrees within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jag
from repro.core.alignment import procrustes as jax_procrustes
from repro.kge.data import synthesize_universe as jax_universe
from repro.kge.trainer import KGETrainer as JaxTrainer
from repro_torch.core import aggregation as tag
from repro_torch.core.alignment import procrustes
from repro_torch.core.ppat import PPAT_BUCKET, _pad_rows
from repro_torch.kge.data import synthesize_universe
from repro_torch.kge.models import params_from_numpy
from repro_torch.kge.trainer import KGETrainer

D = 8


@pytest.fixture(scope="module")
def kgs():
    j, t = jax_universe(seed=1), synthesize_universe(seed=1)
    for n in ("Yago", "Dbpedia"):
        assert np.array_equal(j[n].train, t[n].train)
    return j, t


def _trainers(jkg, tkg, seed):
    jt = JaxTrainer(jkg, "transe", dim=D, seed=seed)
    pt = KGETrainer(tkg, "transe", dim=D, seed=seed, device="cpu")
    pt.params = params_from_numpy({k: np.asarray(v) for k, v in jt.params.items()}, "cpu")
    return jt, pt


def _assert_tables(pt, jt):
    assert set(pt.params) == set(jt.params)
    for k, v in jt.params.items():
        np.testing.assert_array_equal(pt.params[k].numpy(), np.asarray(v), err_msg=k)
    assert pt.model == type(pt.model)(**{f: getattr(jt.model, f)
                                         for f in pt.model.__dataclass_fields__})


@pytest.mark.parametrize("max_neighbors", [2000, 17, 1])
def test_neighbor_and_virtual_structure_equal(kgs, max_neighbors):
    jk, tk = kgs
    ia, ib = tk["Yago"].aligned_with(tk["Dbpedia"])
    assert len(ia) > 0
    jn = jag.neighbor_structure(jk["Yago"], ia, max_neighbors=max_neighbors)
    tn = tag.neighbor_structure(tk["Yago"], ia, max_neighbors=max_neighbors)
    for x, y in zip(tn, jn):
        assert x.dtype == np.int64 and np.array_equal(x, y)
    e0, r0 = tk["Dbpedia"].num_entities, tk["Dbpedia"].num_relations
    jv = jag.virtual_structure(jk["Yago"], ia, ib, e0, r0, max_neighbors=max_neighbors)
    tv = tag.virtual_structure(tk["Yago"], ia, ib, e0, r0, max_neighbors=max_neighbors)
    for x, y in zip(tv, jv):
        assert np.array_equal(x, y)


def test_no_neighbors_gives_none(kgs):
    _, tk = kgs
    kg = tk["Yago"]
    everything = np.arange(kg.num_entities)
    neigh, rels, rows = tag.neighbor_structure(kg, everything)
    assert neigh.shape == (0,) and rels.shape == (0,) and rows.shape == (0, 4)
    assert tag.virtual_structure(kg, everything, everything, 0, 0) is None


@pytest.mark.parametrize("mode", ["average", "replace"])
def test_kgemb_update_matches(kgs, mode):
    jk, tk = kgs
    jt, pt = _trainers(jk["Dbpedia"], tk["Dbpedia"], 3)
    _, ib = tk["Yago"].aligned_with(tk["Dbpedia"])
    synth = np.random.default_rng(4).normal(size=(len(ib), D)).astype(np.float32)
    jag.kgemb_update(jt, ib, jnp.asarray(synth), mode=mode)
    tag.kgemb_update(pt, ib, torch.as_tensor(synth), mode=mode)
    _assert_tables(pt, jt)
    with pytest.raises(ValueError, match="aggregation mode"):
        tag.kgemb_update(pt, ib, torch.as_tensor(synth), mode="median")


def test_virtual_extension_and_strip_match(kgs):
    jk, tk = kgs
    jh, th = _trainers(jk["Dbpedia"], tk["Dbpedia"], 5)
    jc, tc = _trainers(jk["Yago"], tk["Yago"], 6)
    ia, ib = tk["Yago"].aligned_with(tk["Dbpedia"])
    w = np.linalg.qr(np.random.default_rng(7).normal(size=(D, D)))[0].astype(np.float32)
    jve = jag.virtual_extension(jh, jc, jk["Yago"], ia, ib, lambda e: e @ jnp.asarray(w))
    tve = tag.virtual_extension(th, tc, tk["Yago"], ia, ib, lambda e: e @ torch.as_tensor(w))
    assert (tve.n_virtual_ent, tve.n_virtual_rel) == (jve.n_virtual_ent, jve.n_virtual_rel)
    assert np.array_equal(tve.extra_triples, jve.extra_triples)
    for k, v in jh.params.items():
        np.testing.assert_allclose(th.params[k].numpy(), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert th.model.num_entities == jh.model.num_entities > tk["Dbpedia"].num_entities
    jh.strip_virtual()
    th.strip_virtual()
    assert th.params["ent"].shape[0] == tk["Dbpedia"].num_entities
    _assert_tables(th, jh)


def test_procrustes_matches_with_padding_rows():
    rng = np.random.default_rng(8)
    d, n = 16, 100
    a = rng.normal(size=(n, d)).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(d, d)))[0]
    b = (a @ q + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    want = np.asarray(jax_procrustes(jnp.asarray(a), jnp.asarray(b)))
    got = procrustes(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got @ got.T, np.eye(d), rtol=0, atol=1e-5)
    # the zero rows of the PPAT_BUCKET padding add exact zeros to aᵀb
    ap, bp = (_pad_rows(torch.as_tensor(x), PPAT_BUCKET) for x in (a, b))
    assert ap.shape[0] == 128
    torch.testing.assert_close(ap.T @ bp, torch.as_tensor(a).T @ torch.as_tensor(b),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(procrustes(ap, bp).numpy(), want, rtol=0, atol=1e-5)
