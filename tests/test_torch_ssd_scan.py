"""The port's SSD chunk wrapper on the CPU (its plain version) against the
JAX package's Pallas kernel in interpret mode (all three outputs), its
``ssd_chunk_kernel_apply`` and the jnp ``models.ssm.ssd``, on the same
inputs made with numpy, with and without an initial state.

The port sums the in-chunk ``cum`` left to right, the JAX package with
``jnp.cumsum``; both are fp32, so outputs agree within 1e-4 (atol and rtol)
on the JAX kernel test's laws, and within 1e-4 of the largest magnitude on
Mamba2's own laws (A down to −H), where ``cum`` grows large.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_chunk_kernel_apply as jax_apply
from repro.kernels.ssd_scan.ssd_scan import ssd_chunks_fwd as jax_chunks
from repro.models.ssm import ssd as jax_ssd
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models import ssm as tssm

SHAPES = [  # tests/test_kernels.py's SSD cases, then Mamba2's own laws
    (2, 128, 4, 32, 16, 32, "kernel-test"),
    (1, 64, 2, 64, 32, 64, "kernel-test"),
    (2, 256, 8, 32, 64, 64, "kernel-test"),
    (1, 96, 16, 32, 32, 32, "mamba2"),
    (1, 150, 3, 16, 8, 50, "mamba2"),
]


def _inputs(seed, b, s, h, p, n, laws):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if laws == "kernel-test":
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
        a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
        scale = 0.3
    else:  # Mamba2Mixer's: A = −(1..H), dt = softplus(N(0, 1) + softplus⁻¹(dt_init))
        u = rng.random(h)
        dt_init = np.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) + np.log(np.expm1(dt_init))))
        dt = dt.astype(np.float32)
        a = -np.arange(1, h + 1, dtype=np.float32)
        scale = 1.0
    bm = (rng.standard_normal((b, s, 1, n)) * scale).astype(np.float32)
    cm = (rng.standard_normal((b, s, 1, n)) * scale).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, s0


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())),
                               rtol=1e-4, err_msg=what)


@pytest.mark.parametrize("b,s,h,p,n,chunk,laws", SHAPES)
def test_chunks_match_jax_kernel(b, s, h, p, n, chunk, laws):
    x, dt, a, bm, cm, _ = _inputs(s + h, b, s, h, p, n, laws)
    nc, q = s // chunk, chunk
    xg = x.reshape(b, nc, q, h, p).transpose(0, 3, 1, 2, 4)
    dtg = dt.reshape(b, nc, q, h).transpose(0, 3, 1, 2)
    bg, cg = bm.reshape(b, nc, q, n), cm.reshape(b, nc, q, n)
    want = jax_chunks(jnp.asarray(xg), jnp.asarray(dtg), jnp.asarray(a.reshape(h, 1)),
                      jnp.asarray(bg), jnp.asarray(cg), interpret=True)
    # the port's wrapper takes the model's layout as strided views
    tx = torch.from_numpy(x).reshape(b, nc, q, h, p).permute(0, 3, 1, 2, 4)
    tdt = torch.from_numpy(dt).reshape(b, nc, q, h).permute(0, 3, 1, 2)
    before = dict(ks.LAUNCHES)
    got = ks.ssd_chunks(tx, tdt, torch.from_numpy(a), torch.from_numpy(bg),
                        torch.from_numpy(cg))
    assert ks.LAUNCHES == before
    for name, g, w in zip(("y_intra", "chunk_state", "decay"), got, want):
        _close(g.numpy(), w, name)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "initial-state"])
@pytest.mark.parametrize("b,s,h,p,n,chunk,laws", SHAPES)
def test_apply_matches_jax_apply_and_model_ssd(b, s, h, p, n, chunk, laws, with_state):
    x, dt, a, bm, cm, s0 = _inputs(2 * s + h, b, s, h, p, n, laws)
    j = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    js0 = jnp.asarray(s0) if with_state else None
    ts0 = torch.from_numpy(s0) if with_state else None
    t = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    y, fin = ks.ssd_chunk_kernel_apply(*t, chunk=chunk, state=ts0)
    assert y.shape == (b, s, h, p) and fin.shape == (b, h, p, n)
    if laws == "kernel-test":  # the JAX wrapper's kernel path only with G = 1 inputs
        yk, fk = jax_apply(*j, chunk=chunk, state=js0, interpret=True)
        _close(y.numpy(), yk, "y vs jax ssd_chunk_kernel_apply")
        _close(fin.numpy(), fk, "state vs jax ssd_chunk_kernel_apply")
    yr, fr = jax_ssd(*j, chunk, js0)
    _close(y.numpy(), yr, "y vs jax models.ssm.ssd")
    _close(fin.numpy(), fr, "state vs jax models.ssm.ssd")
    # the port's own plain loop over chunks, which the card checks hold the kernel to
    yp, fp = tssm.ssd(*t, chunk, ts0)
    _close(yp.numpy(), yr, "port ssd vs jax ssd")
    _close(fp.numpy(), fr, "port ssd state vs jax ssd")


def test_sequential_cumsum_order():
    """``cum[i] = cum[i−1] + da[i]`` exactly, left to right."""
    rng = np.random.default_rng(0)
    da = torch.from_numpy((rng.standard_normal((3, 257)) * 40).astype(np.float32))
    got = ks.ops.sequential_cumsum(da)
    run = da[:, 0].clone()
    assert torch.equal(got[:, 0], run)
    for i in range(1, 257):
        run = run + da[:, i]
        assert torch.equal(got[:, i], run)


def test_more_than_one_group_raises():
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="one group"):
        ks.ssd_chunk_kernel_apply(x, torch.zeros(1, 8, 2), torch.zeros(2),
                                  torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2, 4), chunk=8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ks.ssd_chunk_kernel_apply(x[:, :6], torch.zeros(1, 6, 2), torch.zeros(2),
                                  torch.zeros(1, 6, 1, 4), torch.zeros(1, 6, 1, 4), chunk=4)
