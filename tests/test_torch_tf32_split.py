"""The split-TF32 ("3xTF32") scheme of the cosine, flash-attention and SSD
chunk kernels, checked on the CPU through its emulation
(``repro_torch.kernels._tf32``).

The kernels split each fp32 operand into ``hi = tf32(x)`` and
``lo = tf32(x − hi)`` and form every product as hi·hi + hi·lo + lo·hi on
the tensor cores. Here the same arithmetic, in 8-wide k-steps accumulated
in fp32, is held to the card checks' tolerances against the plain versions
(cosines: atol 1e-5; attention: atol = rtol = 1e-5), and one TF32 product
on the same inputs is shown to break them. Where the scores are ~50
(qk-norm off), the fp32 plain version is itself more than 1e-5 from a
float64 truth (one rounding of each score, amplified by exp), so there the
split product is held within 1e-5 of the float64 truth, and no farther from
it than the plain version. The tensor cores round their sums in their own
way, so the card checks (``tests/test_torch_cuda.py``, ``chip_smoke.py``)
stay the judge of the kernels themselves.
"""
import math

import numpy as np
import pytest
import torch

from _torch_lm_check import attention_f64
from repro_torch.kernels._tf32 import HI_CLAMP, matmul_tf32, split, tf32_rna
from repro_torch.kernels.csls import cosine_matrix_plain
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_mask
from repro_torch.kernels.ssd_scan import ssd_chunks_plain
from repro_torch.kernels.ssd_scan.ops import sequential_cumsum
from repro_torch.kernels.triple_score.ops import sqrt_rn


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _from_bits(values) -> torch.Tensor:
    return torch.tensor(np.array(values, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, one + 2 ** -11 - 2 ** -23, -(one + 2 ** -11),
                      one + 3 * 2 ** -11, 0.0, -0.0, float("inf")], dtype=torch.float32)
    want = torch.tensor([one + 2 ** -10, one, -(one + 2 ** -10), one + 2 ** -9, 0.0, -0.0,
                         float("inf")], dtype=torch.float32)
    got = tf32_rna(x)
    assert torch.equal(_bits(got), _bits(want))
    # the clamp: the largest float whose rounding stays finite, and the next one up
    assert math.isfinite(float(tf32_rna(torch.tensor([HI_CLAMP]))[0]))
    assert math.isinf(float(tf32_rna(_from_bits([0x7F7FF000]))[0]))


def test_split_reproduces_x_within_2_to_the_minus_22():
    """Normal values from 2^-115 up to FLT_MAX (below 2^-115 lo falls among
    the subnormals, where TF32 keeps fewer bits; such a term is 2^-100 below
    any sum it could change), ±0, and the values near FLT_MAX whose TF32
    rounding would overflow: hi and lo are finite TF32 values and hi + lo is x
    to 2^-22 of |x|."""
    rng = np.random.default_rng(0)
    n = 200_000
    exp = rng.integers(127 - 115, 255, n, dtype=np.uint32)  # biased exponent
    mant = rng.integers(0, 2 ** 23, n, dtype=np.uint32)
    sign = rng.integers(0, 2, n, dtype=np.uint32)
    special = [0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FF000, 0x7F7FEFFF,
               0x7F7FE000, 0xFF7FF001, 0x7F7FF800, 0x3F801000, 0x06000000]
    x = _from_bits(np.concatenate([(sign << 31) | (exp << 23) | mant,
                                   np.array(special, dtype=np.uint32)]))
    hi, lo = split(x)
    assert bool(torch.isfinite(hi).all() and torch.isfinite(lo).all())
    assert bool(((_bits(hi) & 0x1FFF) == 0).all() and ((_bits(lo) & 0x1FFF) == 0).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    rel = err / x.double().abs().clamp_min(1e-300)
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all()), float(rel.max())


def _cos_tf32(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """The kernel's arithmetic: TF32 dot products, fp32 row norms, then
    ``dot · inv_a · inv_b``."""
    inv_a = 1.0 / sqrt_rn((a * a).sum(1) + 1e-18)
    inv_b = 1.0 / sqrt_rn((b * b).sum(1) + 1e-18)
    return matmul_tf32(a, b.T.contiguous(), terms=terms) * inv_a[:, None] * inv_b[None, :]


@pytest.mark.parametrize("d", [100, 33])
def test_split_cosines_within_the_card_tolerance(d):
    rng = np.random.default_rng(d)
    a = torch.from_numpy(rng.standard_normal((512, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2048, d)).astype(np.float32))
    want = cosine_matrix_plain(a, b)
    err3 = float((_cos_tf32(a, b, 3) - want).abs().max())
    err1 = float((_cos_tf32(a, b, 1) - want).abs().max())
    assert err3 <= 1e-5, err3
    assert err1 > 1e-5, err1  # one TF32 product breaks the check: why the split is needed


def _attention_tf32(q, k, v, *, causal, window, terms):
    """Dense masked softmax attention with both products in TF32."""
    b, h, s, dh = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, s, dh)
    kx = k[:, :, None].expand(b, kv, h // kv, t, dh)
    vx = v[:, :, None].expand(b, kv, h // kv, t, dh)
    scores = matmul_tf32(qg, kx.transpose(-1, -2), terms=terms) * (1.0 / math.sqrt(dh))
    mask = attention_mask(s, t, causal=causal, window=window)
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    probs = probs.masked_fill(~mask.any(1)[:, None], 0.0)
    return matmul_tf32(probs, vx, terms=terms).reshape(b, h, s, dh), scores


@pytest.mark.parametrize("dh,causal,window,scale", [
    (128, True, 0, 1.0),     # qwen3-0.6b's heads
    (64, True, 0, 1.0),
    (128, False, 64, 1.0),   # a sliding window
    (64, True, 64, 1.0),
    (128, True, 0, 3.5),     # scores of magnitude ~50: qk-norm off
    (64, False, 0, 3.5),
])
def test_split_attention_within_the_card_tolerance(dh, causal, window, scale):
    rng = np.random.default_rng(dh + 7 * window)
    b, h, kv, s = 1, 4, 2, 256
    q = torch.from_numpy((scale * rng.standard_normal((b, h, s, dh))).astype(np.float32))
    k = torch.from_numpy((scale * rng.standard_normal((b, kv, s, dh))).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kv, s, dh)).astype(np.float32))
    want = attention_ref(q, k, v, causal=causal, window=window)
    got, scores = _attention_tf32(q, k, v, causal=causal, window=window, terms=3)
    if scale > 1:  # large scores: against the float64 truth, beside the plain version
        assert float(scores.abs().max()) >= 40
        want = attention_f64(q, k, v, causal=causal, window=window)
        assert float((got - want).abs().max()) <= float(
            (attention_ref(q, k, v, causal=causal, window=window) - want).abs().max())
    torch.testing.assert_close(got.double(), want.double(), atol=1e-5, rtol=1e-5)
    one, _ = _attention_tf32(q, k, v, causal=causal, window=window, terms=1)
    assert not torch.allclose(one.double(), want.double(), atol=1e-5, rtol=1e-5)


def _ssd_tf32(x, dt, a, bm, cm, *, terms):
    """One chunk the way the SSD kernel computes it (x (H, Q, P), dt (H, Q),
    a (H,), B/C (Q, N)): S = C Bᵀ and the state's product in TF32 k-steps,
    W = S · exp(cum_s − cum_t) · dt_t in fp32 with the exponential taken as
    2^(fp32((cum_s − cum_t) · log2 e)) (the argument rounding of ``__expf``),
    and y = W x over the two 32-column halves of each 64-wide t tile summed
    at the end, as the kernel's two warp halves do."""
    q = x.shape[1]
    cum = sequential_cumsum(dt * a[:, None])
    s_ = matmul_tf32(cm, bm.T.contiguous(), terms=terms)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    diff = torch.where(causal, cum[:, :, None] - cum[:, None, :], 0.0)
    arg = (diff.double() * (1 / math.log(2))).float()
    decay = torch.where(causal, torch.exp2(arg.double()).float(), 0.0)
    w = s_ * decay * dt[:, None, :]
    half = (torch.arange(q) % 64) < 32
    y = sum(matmul_tf32(w[:, :, cols].contiguous(), x[:, cols].contiguous(), terms=terms)
            for cols in (half, ~half))
    decay_end = torch.exp(cum[:, -1:] - cum) * dt
    state = matmul_tf32((x * decay_end[..., None]).transpose(1, 2).contiguous(), bm,
                        terms=terms)
    return y, state


def test_split_ssd_chunk_within_the_card_tolerance():
    """One mamba2-2.7b chunk (Q 256, N 128, P 64) on Mamba2's laws, heads with
    A from −1 down to −80, where cum reaches ~−10³: y and the chunk state
    within 1e-5 of the plain version's largest magnitude, where one TF32
    product is not."""
    rng = np.random.default_rng(80)
    q, n, p = 256, 128, 64
    a = torch.tensor([-1.0, -10.0, -40.0, -80.0])
    h = len(a)
    dt_init = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), h))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        (rng.standard_normal((h, q)) + np.log(np.expm1(dt_init))[:, None]).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((h, q, p)).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((q, n)).astype(np.float32))
    cm = torch.from_numpy(rng.standard_normal((q, n)).astype(np.float32))
    y_p, st_p, _ = ssd_chunks_plain(x[None, :, None], dt[None, :, None], a, bm[None, None],
                                    cm[None, None])
    y_p, st_p = y_p[0, :, 0], st_p[0, :, 0]
    assert float(sequential_cumsum(dt * a[:, None]).min()) < -500

    def rel(got, want):
        return float((got - want).abs().max()) / float(want.abs().max())

    y3, st3 = _ssd_tf32(x, dt, a, bm, cm, terms=3)
    assert rel(y3, y_p) <= 1e-5 and rel(st3, st_p) <= 1e-5, (rel(y3, y_p), rel(st3, st_p))
    y1, st1 = _ssd_tf32(x, dt, a, bm, cm, terms=1)
    assert max(rel(y1, y_p), rel(st1, st_p)) > 1e-5  # one TF32 product breaks the check
