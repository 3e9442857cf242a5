"""Port parity: ``repro_torch.kge.engine`` against the JAX package's
``kge/engine.py`` on the same tables, batches and draws.

The JAX engine samples inside its scan with ``jax.random``; PyTorch cannot
reproduce threefry, so ``jax_draws`` replays the scan's own random calls to
get each epoch's (perm, corrupt_head, rand_ent) and the port is fed those.
Steps and epochs are held within atol 1e-6, whole runs of 3 epochs within
atol 1e-5 (the two packages sum in different orders); shapes, padding and
schedules are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, jax_params, triples

from repro.kge import engine as jeng
from repro.kge.models import MODEL_FAMILIES
from repro.kge.trainer import _epoch as jax_dense_epoch
from repro_torch.kernels.dispatch import resolve_train_impl
from repro_torch.kge import engine as teng
from repro_torch.kge import models as tm
from repro_torch.kge.trainer import _epoch as port_dense_epoch

CPU = torch.device("cpu")


def _pair(family, e, r, d, *, seed=0, norm_ord=1, margin=2.0, dyadic=True):
    m, p = jax_params(family, e, r, d, seed=seed, norm_ord=norm_ord, dyadic_tables=dyadic)
    m = dataclasses.replace(m, margin=margin)
    tmod = tm.KGEModel(family, e, r, d, margin=margin, norm_ord=norm_ord)
    return m, p, tmod


def _batches(rng, e, r, nb, b):
    """(nb, B, 3) positives and their 1:1 corruptions, with a duplicated
    row in every batch so the segment-sum is exercised."""
    pos = np.stack([rng.integers(0, e, (nb, b)), rng.integers(0, r, (nb, b)),
                    rng.integers(0, e, (nb, b))], -1)
    neg = pos.copy()
    ch = rng.random((nb, b)) < 0.5
    rand = rng.integers(0, e, (nb, b))
    neg[..., 0] = np.where(ch, rand, neg[..., 0])
    neg[..., 2] = np.where(~ch, rand, neg[..., 2])
    pos[:, 0] = pos[:, 1]
    neg[:, 0] = neg[:, 1]
    return pos.astype(np.int64), neg.astype(np.int64)


def _assert_tables(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


# --------------------------------------------------------------- one step
@pytest.mark.parametrize("family", MODEL_FAMILIES)
def test_sparse_sgd_step_all_families(family):
    e, r, d, b = 40, 5, 8, 10
    m, p, tmod = _pair(family, e, r, d)
    pos, neg = _batches(np.random.default_rng(1), e, r, 1, b)
    want, wl = jeng.sparse_sgd_step({k: jnp.asarray(v) for k, v in p.items()}, m,
                                    jnp.asarray(pos[0], jnp.int32),
                                    jnp.asarray(neg[0], jnp.int32), jnp.float32(0.25))
    tp = tm.params_from_numpy(p, CPU)
    got, gl = teng.sparse_sgd_step(tp, teng.shape_spec(tmod), torch.as_tensor(pos[0]),
                                   torch.as_tensor(neg[0]), 0.25)
    assert got is tp  # in place
    _assert_tables(got, want, 1e-6)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6, atol=1e-6)


def test_sparse_sgd_step_over_virtual_rows():
    """Batches naming virtual rows (ids ≥ the base counts) update the
    extended tables as the JAX package's step does."""
    e0, r0, d, b = 40, 4, 16, 12
    m, p, _ = _pair("transe", e0, r0, d, margin=4.0)
    p["ent"] = np.concatenate([p["ent"], np.full((6, d), 0.125, np.float32)])
    p["rel"] = np.concatenate([p["rel"], np.full((2, d), 0.25, np.float32)])
    m = dataclasses.replace(m, num_entities=e0 + 6, num_relations=r0 + 2)
    pos, neg = _batches(np.random.default_rng(2), e0 + 6, r0 + 2, 3, b)
    pos[:, 2, 0] = e0 + 1
    pos[:, 3, 1] = r0
    neg[:, 4, 2] = e0 + 5
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = tm.params_from_numpy(p, CPU)
    spec = teng.shape_spec(tm.KGEModel("transe", e0 + 6, r0 + 2, d))
    for i in range(3):
        jp, _ = jeng.sparse_sgd_step(jp, m, jnp.asarray(pos[i], jnp.int32),
                                     jnp.asarray(neg[i], jnp.int32), jnp.float32(0.5))
        teng.sparse_sgd_step(tp, spec, torch.as_tensor(pos[i]), torch.as_tensor(neg[i]), 0.5)
    _assert_tables(tp, jp, 0.0)  # dyadic, l1: every value exact
    assert not np.array_equal(tp["ent"][e0 + 1].numpy(), p["ent"][e0 + 1])


# -------------------------------------------------------------- one epoch
@pytest.mark.parametrize("family", ["transe", "transh", "distmult", "rotate"])
def test_sparse_epoch_matches_jax_sparse_and_dense_epochs(family):
    e, r, d, nb, b = 50, 6, 8, 4, 10
    m, p, tmod = _pair(family, e, r, d)
    pos, neg = _batches(np.random.default_rng(0), e, r, nb, b)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jpos, jneg = jnp.asarray(pos, jnp.int32), jnp.asarray(neg, jnp.int32)
    want_sparse, wl = jeng.sparse_epoch(jp, jeng.shape_spec(m), jpos, jneg, jnp.float32(0.25))
    want_dense, _ = jax_dense_epoch(jp, m, jpos, jneg, jnp.float32(0.25))
    got, gl = teng.sparse_epoch(tm.params_from_numpy(p, CPU), teng.shape_spec(tmod),
                                torch.as_tensor(pos), torch.as_tensor(neg), 0.25)
    dense, dl = port_dense_epoch(tm.params_from_numpy(p, CPU), tmod, torch.as_tensor(pos),
                                 torch.as_tensor(neg), 0.25)
    for want in (want_sparse, want_dense):
        _assert_tables(got, want, 1e-6)
    _assert_tables(dense, want_dense, 1e-6)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(dl), float(wl), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- the epochs loop
@pytest.mark.parametrize("renorm", ["dense", "sparse"])
@pytest.mark.parametrize("impl,jax_impl,family,norm_ord", [
    ("sparse", "xla", "transe", 1),
    ("sparse", "xla", "transd", 2),
    ("fused", "pallas", "transe", 1),
    ("fused", "pallas", "transe", 2),
    ("fused", "pallas", "distmult", 1),
])
def test_train_scan_graph_on_the_reference_draws(impl, jax_impl, family, norm_ord, renorm):
    e, r, d, n, b, epochs = 60, 5, 12, 70, 10, 3
    m, p, tmod = _pair(family, e, r, d, norm_ord=norm_ord, margin=4.0, seed=3)
    tri = triples(np.random.default_rng(4), n, e, r)
    padded, e_pad, r_pad = jeng.pad_tables({k: jnp.asarray(v) for k, v in p.items()}, m)
    jtri = jeng.pad_triples(jnp.asarray(tri, jnp.int32), b)
    key = jax.random.PRNGKey(9)
    want, wl = jeng._train_scan(padded, jtri, key, jnp.float32(0.5), jnp.int32(e),
                                spec=jeng.shape_spec(m), epochs=epochs, batch=b,
                                impl=jax_impl, interpret=True, renorm=renorm)
    n_pad = jtri.shape[0]
    draws = jax_draws(key, epochs, n_pad, n_pad // b, b, e)
    tpad, te_pad, tr_pad = teng.pad_tables(tm.params_from_numpy(p, CPU), tmod)
    assert (te_pad, tr_pad) == (e_pad, r_pad)
    ttri = teng.pad_triples(torch.as_tensor(tri), b)
    np.testing.assert_array_equal(ttri.numpy(), np.asarray(jtri))
    got, gl = teng.train_scan_graph(tpad, ttri, 0.5, e, spec=teng.shape_spec(tmod),
                                    epochs=epochs, batch=b, impl=impl, renorm=renorm,
                                    draws=draws)
    _assert_tables(got, want, 1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-5)
    for k, v in got.items():  # padding rows stay exactly zero
        n_rows = e if k in teng.ENT_KEYS else r
        assert not v[n_rows:].any(), k


def test_own_draws_stay_in_range_and_leave_padding_alone():
    e, r, d, n, b = 70, 5, 8, 300, 50
    tmod = tm.KGEModel("transe", e, r, d)
    params = tm.init_kge(0, tmod, device="cpu")
    padded, e_pad, r_pad = teng.pad_tables(params, tmod)
    tri = teng.pad_triples(torch.as_tensor(triples(np.random.default_rng(0), n, e, r)), b)
    gen = torch.Generator().manual_seed(5)
    nb = tri.shape[0] // b
    for _ in range(20):
        perm, ch, rand = teng.draw_epoch(gen, tri.shape[0], nb, b, e)
        assert sorted(perm.tolist()) == list(range(tri.shape[0]))
        assert int(rand.min()) >= 0 and int(rand.max()) < e
        assert ch.dtype == torch.bool and 0 < int(ch.sum()) < ch.numel()
    out, losses = teng.train_scan_graph(padded, tri, 0.5, e, spec=teng.shape_spec(tmod),
                                        epochs=4, batch=b, impl="fused", generator=gen)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())
    assert not out["ent"][e:].any() and not out["rel"][r:].any()
    assert not torch.equal(out["ent"][:e], params["ent"])


# ------------------------------------------------------------- padding
def test_padding_helpers_equal_jax():
    for n, g in ((1, 256), (256, 256), (257, 256), (491_078, 256), (14_085, 64)):
        assert teng.bucket(n, g) == jeng.bucket(n, g)
    for tri_pad, rows in ((160, 256), (1_638_400, 491_264), (40, 1_000)):
        assert teng.resolve_renorm(tri_pad, rows) == jeng.resolve_renorm(tri_pad, rows)
    assert teng.resolve_renorm(1_638_400, 491_264) == "dense"
    rng = np.random.default_rng(0)
    tri = triples(rng, 90, 50, 4)
    for n, b in ((90, 30), (64, 16), (7, 10), (90, 7)):
        np.testing.assert_array_equal(
            teng.pad_triples(torch.as_tensor(tri[:n]), b).numpy(),
            np.asarray(jeng.pad_triples(jnp.asarray(tri[:n], jnp.int32), b)))
    for family in ("transe", "transr", "transd", "complex"):
        m, p, tmod = _pair(family, 130, 7, 4)
        want, e_pad, r_pad = jeng.pad_tables({k: jnp.asarray(v) for k, v in p.items()}, m)
        src = tm.params_from_numpy(p, CPU)
        got, te_pad, tr_pad = teng.pad_tables(src, tmod)
        assert (te_pad, tr_pad) == (e_pad, r_pad)
        _assert_tables(got, want, 0.0)
        assert all(got[k].data_ptr() != src[k].data_ptr() for k in src)
        stripped = teng.strip_tables(got, tmod)
        _assert_tables(stripped, jeng.strip_tables(want, m), 0.0)
        for k in stripped:  # copies, not views of the padded storage
            assert stripped[k].untyped_storage().data_ptr() != got[k].untyped_storage().data_ptr()


def test_train_epochs_device_roundtrip_leaves_its_input_alone():
    e, r, d = 130, 7, 12
    tmod = tm.KGEModel("transe", e, r, d)
    params = tm.init_kge(0, tmod, device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    tri = triples(np.random.default_rng(0), 90, e, r).astype(np.int32)
    out, losses = teng.train_epochs_device(params, tmod, tri, epochs=2, batch_size=30,
                                           lr=0.5, impl="fused",
                                           generator=torch.Generator().manual_seed(1))
    assert out["ent"].shape == (e, d) and out["rel"].shape == (r, d)
    assert losses.shape == (2,)
    for k in params:
        assert torch.equal(params[k], before[k])


def test_resolve_train_impl(monkeypatch):
    monkeypatch.delenv("REPRO_TRAIN_IMPL", raising=False)
    # the default follows the tables' device, as the JAX package's follows its
    # backend: the kernel on the card, the autograd step on the CPU
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    for dev in (None, cpu, "cpu"):
        assert resolve_train_impl(None, "transe", dev) == "sparse"
        assert resolve_train_impl(None, "distmult", dev) == "sparse"
    assert resolve_train_impl(None, "transe", card) == "fused"
    assert resolve_train_impl(None, "distmult", "cuda:0") == "fused"
    assert resolve_train_impl(None, "transh", card) == "sparse"
    assert resolve_train_impl(None, "transh", cpu) == "sparse"
    assert resolve_train_impl("fused", "transe", cpu) == "fused"
    assert resolve_train_impl("pallas", "distmult", cpu) == "fused"
    assert resolve_train_impl("reference") == "reference"
    assert resolve_train_impl("pallas", "transe") == "fused"
    assert resolve_train_impl("pallas", "rotate") == "sparse"
    assert resolve_train_impl("xla", "transe") == "sparse"
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "xla")
    assert resolve_train_impl(None, "transe", card) == "sparse"
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "pallas")
    assert resolve_train_impl(None, "transe", cpu) == "fused"
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "reference")
    assert resolve_train_impl(None, "transe") == "reference"
    with pytest.raises(ValueError):
        resolve_train_impl("nope")
