"""The port's flash-attention wrapper on the CPU (its plain version) against
the JAX package's Pallas kernel in interpret mode and its ``attention_ref``
oracle, on the same inputs made with numpy.

Tolerances: 1e-5 (atol and rtol) at fp32, as the JAX package's own kernel
test; 2e-2 at bf16, where both frameworks round their fp32 results to bf16
and may land one bf16 ulp apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention as fa

SHAPES = [  # tests/test_kernels.py's flash-attention cases
    (1, 2, 1, 128, 64, True, 0),
    (2, 4, 2, 256, 64, True, 0),
    (1, 4, 4, 128, 128, True, 0),   # MHA
    (1, 2, 2, 256, 32, False, 0),   # bidirectional (encoder)
    (1, 2, 1, 256, 64, True, 64),   # sliding window
    (2, 8, 2, 128, 64, True, 0),    # GQA 4:1
]


def _inputs(seed, b, h, kv, s, dh, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((b, h, s, dh)).astype(np.float32),
            rng.standard_normal((b, kv, t, dh)).astype(np.float32),
            rng.standard_normal((b, kv, t, dh)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,dh,causal,window", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(b, h, kv, s, dh, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(s + h + dh, b, h, kv, s, dh), dtype)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert fa.LAUNCHES == before  # CPU tensors take the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 1e-5 if dtype == "fp32" else 2e-2
    got = got.float().numpy()
    kern = jax_flash_attention(jq, jk, jv, causal=causal, window=window, block_q=64,
                               block_k=64, interpret=True)
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("s,causal,window", [(333, True, 0), (333, True, 64), (333, False, 0),
                                             (7, True, 3), (1, True, 0)])
def test_ragged_lengths_match_jax_oracle(s, causal, window):
    """Lengths the Pallas kernel cannot take (S % block ≠ 0): against the
    JAX oracle only. The port's wrapper takes any S."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(s, 1, 4, 2, s, 64), "fp32")
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_strided_views_and_empty_rows():
    """The model's (B, S, H, Dh) projections go in as transposed views and
    come back with q's strides; a causal window past T leaves rows with no
    visible key, which give 0 (the Pallas kernel's rule)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(0, 1, 4, 2, 40, 32))
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    out = fa.flash_attention(qv, k, v, causal=True, window=0)
    torch.testing.assert_close(out, fa.flash_attention(q, k, v), atol=0, rtol=0)
    short_k, short_v = k[:, :, :8], v[:, :, :8]  # T = 8 < S = 40, window 4
    out = fa.flash_attention(q, short_k, short_v, causal=True, window=4)
    assert torch.equal(out[:, :, 11:], torch.zeros_like(out[:, :, 11:]))
    assert bool(out[:, :, :11].abs().sum(-1).gt(0).all())
