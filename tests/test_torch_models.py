"""Port parity: ``repro_torch.kge.models`` against the JAX package's
``kge.models`` on the same tables (rtol = atol = 1e-5: the two frameworks
sum in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_params, triples

from repro.kge import models as jm
from repro_torch.kge import models as tm

E, R = 40, 5
TOL = dict(rtol=1e-5, atol=1e-5)


def _both(family, d=12, norm_ord=1, seed=0):
    m, p = jax_params(family, E, R, d, seed=seed, norm_ord=norm_ord, dyadic_tables=False)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = tm.params_from_numpy(p, device="cpu")
    return m, jp, tm.KGEModel(family, E, R, d, norm_ord=norm_ord), tp


@pytest.mark.parametrize("family", tm.MODEL_FAMILIES)
@pytest.mark.parametrize("norm_ord", [1, 2])
def test_score_triples_parity(family, norm_ord):
    jmod, jp, tmod, tp = _both(family, norm_ord=norm_ord)
    tri = triples(np.random.default_rng(1), 17, E, R)
    want = np.asarray(jm.score_triples(jp, jmod, *(jnp.asarray(tri[:, i]) for i in range(3))))
    got = tm.score_triples(tp, tmod, *(torch.as_tensor(tri[:, i]) for i in range(3)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("family,norm_ord", [
    ("transe", 1), ("transe", 2), ("distmult", 1), ("complex", 1), ("rotate", 1),
])
def test_lp_queries_gold_and_score_all_parity(family, norm_ord):
    jmod, jp, tmod, tp = _both(family, norm_ord=norm_ord)
    tri = triples(np.random.default_rng(2), 9, E, R)
    jh, jr, jt = (jnp.asarray(tri[:, i]) for i in range(3))
    th, tr, tt = (torch.as_tensor(tri[:, i]) for i in range(3))
    for side in ("tail", "head"):
        if side == "tail":
            jq, jtab, jmode = jm.lp_query_tails(jp, jmod, jh, jr)
            tq, ttab, tmode = tm.lp_query_tails(tp, tmod, th, tr)
            jidx, tidx = jt, tt
            want_all = jm.score_all_tails(jp, jmod, jh, jr, via_kernel=False)
            got_all = tm.score_all_tails(tp, tmod, th, tr)
        else:
            jq, jtab, jmode = jm.lp_query_heads(jp, jmod, jr, jt)
            tq, ttab, tmode = tm.lp_query_heads(tp, tmod, tr, tt)
            jidx, tidx = jh, th
            want_all = jm.score_all_heads(jp, jmod, jr, jt, via_kernel=False)
            got_all = tm.score_all_heads(tp, tmod, tr, tt)
        assert tmode == jmode
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
        np.testing.assert_array_equal(ttab.numpy(), np.asarray(jtab))
        np.testing.assert_allclose(
            tm.lp_gold_scores(tq, ttab, tidx, tmode).numpy(),
            np.asarray(jm.lp_gold_scores(jq, jtab, jidx, jmode)), **TOL,
        )
        np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all), **TOL)


@pytest.mark.parametrize("family", ["transh", "transr", "transd"])
def test_projection_families_have_no_decomposition(family):
    _, _, tmod, tp = _both(family)
    idx = torch.arange(3)
    assert tm.lp_query_tails(tp, tmod, idx, idx) is None
    assert tm.lp_query_heads(tp, tmod, idx, idx) is None
    jmod, jp, _, _ = _both(family)
    want = np.asarray(jm.score_all_tails(jp, jmod, jnp.arange(3), jnp.arange(3),
                                         via_kernel=False))
    np.testing.assert_allclose(tm.score_all_tails(tp, tmod, idx, idx).numpy(), want, **TOL)


@pytest.mark.parametrize("family", tm.MODEL_FAMILIES)
def test_init_kge_shapes_bounds_and_seed(family):
    d = 10
    m = tm.KGEModel(family, E, R, d)
    p = tm.init_kge(7, m, device="cpu")
    jp = jm.init_kge(__import__("jax").random.PRNGKey(0), jm.KGEModel(family, E, R, d))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in p.values())
    bound = 6.0 / np.sqrt(d)
    assert float(p["ent"].abs().max()) <= bound
    if family == "rotate":
        assert float(p["rel"].abs().max()) <= np.pi
    # same seed, same tables; an explicit generator is honoured
    again = tm.init_kge(7, m, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    g = torch.Generator().manual_seed(7)
    assert all(torch.equal(p[k], v) for k, v in tm.init_kge(g, m, device="cpu").items())
