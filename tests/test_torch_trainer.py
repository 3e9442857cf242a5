"""Port parity: ``repro_torch.kge.trainer.KGETrainer`` against the JAX
package's ``KGETrainer``, started from the JAX trainer's own tables.

* ``impl="reference"`` draws from the same ``np.random.default_rng(seed)``
  stream in both packages, so the two dense host loops are comparable draw
  for draw (atol 1e-5 after 2 epochs);
* the engine paths (``fused``/``pallas``, ``sparse``/``xla``) are fed the
  JAX engine's draws (``jax_draws``) and held within atol 1e-5 after 3
  epochs; then link prediction on the trained tables ranks equally up to
  near-ties — the slice as a whole;
* snapshots, restores and published serving versions are copies that later
  in-place training leaves as they were.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, near_tie_ok, triples

from repro.kge import eval as jeval
from repro.kge.engine import pad_triples as jax_pad_triples
from repro.kge.trainer import KGETrainer as JaxTrainer
from repro_torch.kge import eval as teval
from repro_torch.kge import models as tm
from repro_torch.kge.trainer import KGETrainer
from repro_torch.serving import KGEServingTier

E, R, D, BATCH = 60, 5, 8, 10
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def kg():
    rng = np.random.default_rng(0)
    allt = np.unique(triples(rng, 200, E, R), axis=0)
    rng.shuffle(allt)
    return SimpleNamespace(num_entities=E, num_relations=R, train=allt[:150].astype(np.int32),
                           valid=allt[150:170].astype(np.int32),
                           test=allt[170:190].astype(np.int32))


def _pair(kg, family, *, norm_ord=1, seed=0):
    jt = JaxTrainer(kg, family, dim=D, batch_size=BATCH, seed=seed)
    if norm_ord != 1:
        jt.model = dataclasses.replace(jt.model, norm_ord=norm_ord)
    pt = KGETrainer(kg, family, dim=D, batch_size=BATCH, seed=seed, device="cpu")
    pt.model = dataclasses.replace(pt.model, norm_ord=norm_ord)
    pt.params = tm.params_from_numpy({k: np.asarray(v) for k, v in jt.params.items()}, CPU)
    return jt, pt


def _assert_tables(pt, jt, atol):
    assert set(pt.params) == set(jt.params)
    for k, v in jt.params.items():
        np.testing.assert_allclose(pt.params[k].numpy(), np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["transe", "transh", "distmult"])
def test_reference_path_matches_jax(kg, family):
    jt, pt = _pair(kg, family)
    for _ in range(2):
        jl = jt.train_epochs(1, impl="reference")
        pl = pt.train_epochs(1, impl="reference")
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_tables(pt, jt, 1e-5)
    assert pt.rng.bit_generator.state == jt.rng.bit_generator.state


def _engine_key(seed):
    return jax.random.split(jax.random.PRNGKey(seed + 7919))[1]


@pytest.mark.parametrize("impl,jax_impl,family,norm_ord", [
    ("fused", "pallas", "transe", 1),
    ("fused", "pallas", "transe", 2),
    ("fused", "pallas", "distmult", 1),
    ("sparse", "xla", "transh", 1),
])
def test_engine_path_on_the_jax_draws_then_link_prediction(kg, impl, jax_impl, family,
                                                           norm_ord):
    jt, pt = _pair(kg, family, norm_ord=norm_ord)
    epochs = 3
    jl = jt.train_epochs(epochs, impl=jax_impl)
    n_pad = jax_pad_triples(jnp.asarray(kg.train), BATCH).shape[0]
    draws = jax_draws(_engine_key(0), epochs, n_pad, n_pad // BATCH, BATCH, E)
    pl = pt.train_epochs(epochs, impl=impl, draws=draws)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=1e-5)
    _assert_tables(pt, jt, 1e-5)
    # the trained tables through the rest of the slice: link prediction
    test, filt_t, filt_h = jeval.build_score_inputs(kg, max_test=20)
    for side, filt in (("tail", filt_t), ("head", filt_h)):
        jc = np.asarray(jeval.side_counts_graph(
            jt.params, jt.model, *(jnp.asarray(test[:, i]) for i in range(3)),
            jnp.asarray(filt), side=side, impl="xla"))
        h, r, t = (torch.as_tensor(test[:, i].astype(np.int64)) for i in range(3))
        tc = teval.side_counts_graph(pt.params, pt.model, h, r, t, torch.as_tensor(filt),
                                     side=side).numpy()
        if side == "tail":
            scores = tm.score_all_tails(pt.params, pt.model, h, r).numpy()
            gold = scores[np.arange(len(test)), test[:, 2]]
        else:
            scores = tm.score_all_heads(pt.params, pt.model, r, t).numpy()
            gold = scores[np.arange(len(test)), test[:, 0]]
        assert near_tie_ok(tc, jc, scores, gold)


def test_own_generator_is_deterministic_and_advances(kg):
    a = KGETrainer(kg, "transe", dim=D, batch_size=BATCH, seed=4, device="cpu")
    b = KGETrainer(kg, "transe", dim=D, batch_size=BATCH, seed=4, device="cpu")
    assert a.consume_engine_key() is a.consume_engine_key()
    la = [a.train_epochs(1) for _ in range(2)]
    lb = [b.train_epochs(1) for _ in range(2)]
    assert la == lb and np.isfinite(la).all()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
    assert a.params["ent"].shape == (E, D)


@pytest.mark.parametrize("family", ["transe", "transh", "transr", "transd", "distmult",
                                    "complex", "rotate"])
def test_extend_and_strip_match_jax(kg, family):
    jt, pt = _pair(kg, family)
    rng = np.random.default_rng(1)
    half = family == "rotate"
    v_ent = rng.normal(0, 0.3, (4, D)).astype(np.float32)
    v_rel = rng.normal(0, 0.3, (2, D // 2 if half else D)).astype(np.float32)
    extra = np.array([[E, 0, 1], [2, R, E + 3]], np.int32)
    jt.extend_tables(jnp.asarray(v_ent), jnp.asarray(v_rel), extra)
    pt.extend_tables(v_ent, v_rel, extra)
    assert pt.model == dataclasses.replace(pt.model, num_entities=E + 4, num_relations=R + 2)
    _assert_tables(pt, jt, 0.0)
    extended = dict(pt.params)
    jt.strip_virtual()
    pt.strip_virtual()
    _assert_tables(pt, jt, 0.0)
    assert (pt.model.num_entities, pt.model.num_relations) == (E, R)
    for k, v in pt.params.items():  # copies, not views of the extended tables
        if v.shape != extended[k].shape:
            assert v.untyped_storage().data_ptr() != extended[k].untyped_storage().data_ptr()


def test_extended_training_samples_virtual_rows(kg):
    jt, pt = _pair(kg, "transe")
    extra = np.array([[E, 0, 1], [2, R, E + 3]], np.int32)
    for t in (jt, pt):
        t.extend_tables(np.full((4, D), 0.1, np.float32), np.full((2, D), 0.2, np.float32),
                        extra)
    jl = jt.train_epochs(1, impl="reference")
    pl = pt.train_epochs(1, impl="reference")
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    _assert_tables(pt, jt, 1e-5)
    pt.train_epochs(1, impl="fused")  # the fused path over the extended store and tables
    assert pt.params["ent"].shape == (E + 4, D)


def test_snapshot_and_restore_survive_in_place_training(kg):
    _, pt = _pair(kg, "transe")
    snap = pt.snapshot()
    kept = {k: v.clone() for k, v in snap.items()}
    pt.train_epochs(1, impl="fused")  # in place on pt.params
    assert not torch.equal(pt.params["ent"], kept["ent"])
    for k in kept:
        assert torch.equal(snap[k], kept[k])
    pt.restore(snap)
    for k in kept:
        assert torch.equal(pt.params[k], kept[k])
    pt.train_epochs(1, impl="fused")
    pt.restore(snap)  # restore copied: the snapshot was not trained over
    for k in kept:
        assert torch.equal(pt.params[k], kept[k])


def test_accessors_read_and_write_rows(kg):
    jt, pt = _pair(kg, "transe")
    idx = np.array([3, 7, 59])
    np.testing.assert_array_equal(pt.get_entity_embeddings(idx).numpy(),
                                  np.asarray(jt.get_entity_embeddings(idx)))
    np.testing.assert_array_equal(pt.get_relation_embeddings(idx[:2] % R).numpy(),
                                  np.asarray(jt.get_relation_embeddings(idx[:2] % R)))
    emb = np.full((3, D), 0.5, np.float32)
    jt.set_entity_embeddings(idx, jnp.asarray(emb))
    pt.set_entity_embeddings(idx, emb)
    jt.set_relation_embeddings(idx[:1] % R, jnp.asarray(emb[:1]))
    pt.set_relation_embeddings(idx[:1] % R, emb[:1])
    _assert_tables(pt, jt, 0.0)


def test_published_version_is_unchanged_by_later_training(kg):
    """Publish the trainer's tables, train in place, and the pinned version
    still answers as before — and the trainer's tables did move."""
    _, pt = _pair(kg, "transe")
    tier = KGEServingTier(pt.params, pt.model, kg.train, device=CPU, block_e=16)
    q = kg.test[:8]
    first = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    published = {k: v.clone() for k, v in tier._active.params.items()}
    before = pt.params["ent"].clone()
    pt.train_epochs(1, impl="fused")
    assert not torch.equal(pt.params["ent"], before)
    again = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    assert first.version == again.version == 0
    np.testing.assert_array_equal(again.result, first.result)
    for k, v in tier._active.params.items():
        assert torch.equal(v, published[k])
    # a version holds its own copy even when the source is trained in place
    # by the kernel's own entry point
    from repro_torch.kernels.sparse_update import fused_sparse_step
    tv = tier.publish(pt.params)
    kept = tv.params["ent"].clone()
    pos = torch.as_tensor(kg.train[:BATCH].astype(np.int64))
    fused_sparse_step(pt.params["ent"], pt.params["rel"], pos, pos.flip(0), 0.5)
    assert torch.equal(tv.params["ent"], kept)
