"""The port's optimizer (``repro_torch.optim``) against the JAX package's:
the cosine schedule and AdamW, on inputs made with numpy.

Tolerances: the schedule is float32 arithmetic in the same order in both
packages; only ``cos`` and ``pow`` may differ in the last bit, so rates agree
within rtol 1e-6. AdamW's math is float32 in both; the two frameworks'
``sqrt``, ``pow`` and division may differ by an ulp, so fp32 parameters and
moments agree within rtol 1e-6 (atol 1e-7 for values near 0). bf16
parameters and moments are rounded once from the fp32 result, so an ulp of
difference before rounding can flip the rounding: they agree within one
bf16 ulp (rtol 2**-7, atol 1e-6).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim.schedule import cosine_schedule as jcosine
from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm

@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced cards' tensors are small: one intra-op thread is as fast
    alone, and stays fast beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FP32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("warmup,total,min_frac", [(5, 40, 0.1), (0, 10, 0.0), (20, 20, 0.3)])
def test_cosine_schedule_matches_jax(warmup, total, min_frac):
    for step in range(total + 6):
        want = np.asarray(jcosine(step, base_lr=3e-3, warmup=warmup, total=total,
                                  min_frac=min_frac))
        got = cosine_schedule(step, base_lr=3e-3, warmup=warmup, total=total, min_frac=min_frac)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a tensor step (the optimizer's int32 counter) gives the same rates
    got = cosine_schedule(torch.tensor(7, dtype=torch.int32), base_lr=3e-3, warmup=warmup,
                          total=total, min_frac=min_frac)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jcosine(jnp.int32(7), base_lr=3e-3, warmup=warmup,
                                        total=total, min_frac=min_frac)), rtol=1e-6)


def _tree(rng, dtype):
    shapes = {"w": (7, 5), "norm": (5,), "table": (11, 5)}
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype) for k, s in shapes.items()}


CASES = [  # (grad_clip, weight_decay, moment dtype, param dtype)
    (0.0, 0.1, "float32", "float32"),
    (1.0, 0.1, "float32", "float32"),
    (1e-3, 0.0, "float32", "float32"),
    (0.5, 0.1, "bfloat16", "float32"),
    (1.0, 0.1, "float32", "bfloat16"),
    (1.0, 0.0, "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("clip,wd,mdt,pdt", CASES,
                         ids=[f"clip{c}-wd{w}-m{m}-p{p}" for c, w, m, p in CASES])
def test_adamw_update_matches_jax(clip, wd, mdt, pdt):
    rng = np.random.default_rng(3)
    np_p = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[pdt]
    params = _tree(rng, np_p)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jadamw.adamw_init(jparams, moment_dtype=jnp.dtype(mdt))
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[pdt]
    tparams = {k: torch.from_numpy(v.astype(np.float32)).to(tdt) for k, v in params.items()}
    tstate = adamw_init(tparams, moment_dtype=mdt)
    assert all(m.dtype == (torch.float32 if mdt == "float32" else torch.bfloat16)
               for m in tstate.mu.values())
    tol = BF16 if "bfloat16" in (mdt, pdt) else FP32
    for step in range(4):
        grads = {k: (rng.standard_normal(v.shape) * 10 ** (step - 2)).astype(np.float32)
                 for k, v in params.items()}
        grads["norm"][:2] = 0.0  # zero gradients still decay and move by the moments
        lr = 1e-2 / (step + 1)
        jparams, jstate = jadamw.adamw_update(
            {k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams, lr=jnp.float32(lr),
            weight_decay=wd, grad_clip=clip)
        tstate = adamw_update({k: torch.from_numpy(g) for k, g in grads.items()}, tstate,
                              tparams, lr=torch.tensor(lr, dtype=torch.float32),
                              weight_decay=wd, grad_clip=clip)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in params:
            assert tparams[k].dtype == tdt
            np.testing.assert_allclose(tparams[k].float().numpy(),
                                       np.asarray(jparams[k], np.float32), **tol)
            np.testing.assert_allclose(tstate.mu[k].float().numpy(),
                                       np.asarray(jstate.mu[k], np.float32), **tol)
            np.testing.assert_allclose(tstate.nu[k].float().numpy(),
                                       np.asarray(jstate.nu[k], np.float32), **tol)


def test_global_norm_and_first_step_moves_by_lr():
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (9,), (2, 2, 2))]
    np.testing.assert_allclose(global_norm([torch.from_numpy(g) for g in grads]).numpy(),
                               np.asarray(jadamw.global_norm(grads)), rtol=1e-6)
    # Adam's first step (no decay, no clip) moves each element by lr·|g|/(|g| + eps)
    p = {"a": torch.zeros(5)}
    g = {"a": torch.tensor([1.0, -2.0, 1e-3, -1e-4, 0.0])}
    st = adamw_update(g, adamw_init(p), p, lr=0.5, weight_decay=0.0)
    assert isinstance(st, AdamWState) and int(st.step) == 1
    want = -0.5 * g["a"] / (g["a"].abs() + 1e-8)
    torch.testing.assert_close(p["a"], want, rtol=1e-6, atol=1e-7)
