"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX package's ``apply_moe_gather``, on the JAX package's own weights
(``init_moe``) and inputs made with numpy, for the reduced mixtral, kimi
(one shared expert) and jamba cards at fp32; and the reference's dispatch
invariants (``tests/test_moe_invariants.py``) on the port.

Routing decisions are integers and must match exactly: the chosen expert
ids, the kept mask. Outputs agree within atol/rtol 1e-5 (the two frameworks
sum in different orders), the load-balance loss within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jcfg
from repro.models import moe as jmoe
from repro_torch import configs as tcfg
from repro_torch.models import moe as tmoe

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = {"mixtral": "mixtral-8x22b", "kimi": "kimi-k2-1t-a32b", "jamba": "jamba-1.5-large-398b"}


def _cfgs(arch, **moe_kw):
    j = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32")
    t = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
    if moe_kw:
        j = j.replace(moe=dataclasses.replace(j.moe, **moe_kw))
        t = t.replace(moe=dataclasses.replace(t.moe, **moe_kw))
    return j, t


def _layer(arch, seed=0, **moe_kw):
    """(jax cfg, jax params, port cfg, port MoE carrying the same weights)."""
    jc, tc = _cfgs(arch, **moe_kw)
    p = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(seed), jc, jc.d_model))
    mod = tmoe.MoE(tc, device="cpu")
    mod.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in p.items()})
    return jc, p, tc, mod


def _jax_routing(p, jc, x):
    """The reference's routing decisions on x (B, S, d): expert ids (T, k),
    gates, and the kept mask (T·k,) at the joint capacity — the lines of
    ``apply_moe_gather`` that the function does not return."""
    m = jc.moe
    xf = jnp.asarray(x.reshape(-1, x.shape[-1]))
    probs = jax.nn.softmax(xf @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, m.experts_per_token)
    cap = jmoe.capacity(xf.shape[0], jc)
    keep, _ = jmoe._dispatch_positions(idx.reshape(-1), m.num_experts, cap)
    return np.asarray(idx), np.asarray(keep), np.asarray(probs)


CASES = {
    "mixtral": ("mixtral", {}),
    "kimi-shared-expert": ("kimi", {}),
    "jamba": ("jamba", {}),
    "mixtral-drops": ("mixtral", {"capacity_factor": 0.5}),
    "kimi-drops": ("kimi", {"capacity_factor": 0.5}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_layer_matches_apply_moe_gather(case):
    """T = 128 tokens (2 × 64) routed jointly: ids and keep mask exact, y and
    aux within tolerance. At capacity factor 0.5 the reference drops
    assignments, and the port drops the same ones."""
    arch, moe_kw = CASES[case]
    jc, p, tc, mod = _layer(ARCHS[arch], **moe_kw)
    x = np.random.default_rng(3).standard_normal((2, 64, jc.d_model)).astype(np.float32)
    want, want_aux = jmoe.apply_moe_gather(p, jnp.asarray(x), jc)
    with torch.no_grad():
        got, aux, info = mod(torch.from_numpy(x), details=True)
    idx, keep, _ = _jax_routing(p, jc, x)
    np.testing.assert_array_equal(info["idx"].numpy(), idx)
    np.testing.assert_array_equal(info["keep"].numpy(), keep)
    assert info["capacity"] == jmoe.capacity(128, jc)
    assert (not keep.all()) == ("drops" in case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_router_ties_go_to_the_lower_expert():
    """Router columns 1 and 2 equal: every token's probabilities of experts 1
    and 2 tie exactly. Where the pair straddles the top-2 boundary, both
    the reference (``lax.top_k``) and the port pick expert 1."""
    jc, p, tc, mod = _layer(ARCHS["mixtral"], seed=1)
    p["router"][:, 2] = p["router"][:, 1]
    with torch.no_grad():
        mod.router[:, 2] = mod.router[:, 1]
    x = np.random.default_rng(4).standard_normal((1, 128, jc.d_model)).astype(np.float32)
    idx, keep, probs = _jax_routing(p, jc, x)
    assert (probs[:, 1] == probs[:, 2]).all()
    straddle = (idx == 1).any(1) & ~(idx == 2).any(1)
    assert straddle.sum() > 0 and not ((idx == 2).any(1) & ~(idx == 1).any(1)).any()
    with torch.no_grad():
        got, _, info = mod(torch.from_numpy(x), details=True)
    np.testing.assert_array_equal(info["idx"].numpy(), idx)
    want, _ = jmoe.apply_moe_gather(p, jnp.asarray(x), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["mixtral", "kimi"])
def test_per_row_groups_equal_the_reference_row_by_row(arch):
    """``groups="row"``: each row routed alone, with its own capacity and
    drops (factor 0.5, so rows drop), equals ``apply_moe_gather`` applied to
    that row alone; aux is the mean of the rows' losses."""
    jc, p, tc, mod = _layer(ARCHS[arch], seed=2, capacity_factor=0.5)
    x = np.random.default_rng(5).standard_normal((4, 32, jc.d_model)).astype(np.float32)
    with torch.no_grad():
        got, aux = mod(torch.from_numpy(x), groups="row")
    auxes, dropped = [], 0
    for b in range(4):
        want, a = jmoe.apply_moe_gather(p, jnp.asarray(x[b:b + 1]), jc)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want), **TOL)
        auxes.append(float(a))
        dropped += int((~_jax_routing(p, jc, x[b:b + 1])[1]).sum())
    assert dropped > 0
    assert abs(float(aux) - float(np.mean(auxes))) <= 1e-6
    with pytest.raises(ValueError, match="groups"):
        mod(torch.from_numpy(x), groups="slot")


def test_capacity_equals_the_reference():
    for arch in sorted(jcfg.ARCHS):
        jc = jcfg.get_config(arch)
        if not jc.moe.enabled:
            continue
        for cfg_j, cfg_t in ((jc, tcfg.get_config(arch)),
                             (jcfg.reduced(jc), tcfg.reduced(tcfg.get_config(arch)))):
            got = [tmoe.capacity(t, cfg_t) for t in range(1, 4097)]
            assert got == [jmoe.capacity(t, cfg_j) for t in range(1, 4097)]
            assert got == sorted(got) and all(c % 8 == 0 and c >= 8 for c in got)


# ------------------------------------------- the reference's invariants
@given(n=st.integers(1, 200), buckets=st.integers(1, 8), cap=st.integers(1, 64),
       seed=st.integers(0, 100))
@settings(max_examples=40, deadline=None)
def test_dispatch_positions_invariants(n, buckets, cap, seed):
    """Kept rows land in their own bucket's slot range, each slot once, at
    most ``cap`` per bucket; keep and destination equal the reference's
    ``_dispatch_positions`` (the port's ids are never invalid)."""
    ids = np.random.default_rng(seed).integers(0, buckets, n)
    keep, dest = tmoe.dispatch_positions(torch.from_numpy(ids)[None], buckets, cap)
    keep, dest = keep[0].numpy(), dest[0].numpy()
    assert (dest[keep] < buckets * cap).all() and (dest[~keep] == buckets * cap).all()
    assert len(np.unique(dest[keep])) == keep.sum()
    for b in range(buckets):
        in_b = keep & (ids == b)
        assert in_b.sum() <= cap
        slots = dest[in_b] - b * cap
        assert ((slots >= 0) & (slots < cap)).all()
    jkeep, jdest = jmoe._dispatch_positions(jnp.asarray(ids), buckets, cap)
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    np.testing.assert_array_equal(dest, np.asarray(jdest))


@given(seed=st.integers(0, 20))
@settings(max_examples=10, deadline=None)
def test_moe_output_zero_for_zero_weights(seed):
    """Zero expert weights → zero output: routing cannot leak its inputs."""
    _, _, tc, mod = _layer(ARCHS["mixtral"])
    with torch.no_grad():
        for w in (mod.w_gate, mod.w_up, mod.w_down):
            w.zero_()
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (2, 8, tc.d_model)).astype(np.float32))
        y, _ = mod(x)
    assert float(y.abs().max()) == 0.0


def test_moe_permutation_equivariance():
    """Permuting tokens permutes outputs (capacity wide enough for no drops)."""
    _, _, tc, mod = _layer(ARCHS["mixtral"], capacity_factor=16.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, tc.d_model)).astype(np.float32))
    perm = np.random.default_rng(0).permutation(16)
    with torch.no_grad():
        y, _ = mod(x)
        y_perm, _ = mod(x[:, perm])
    np.testing.assert_allclose(y[:, perm].numpy(), y_perm.numpy(), atol=1e-5)
