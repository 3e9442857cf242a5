"""The port's encoder-decoder and patch-prefix paths against the JAX
package's, on the JAX package's own weights (``lm_params_from_numpy``) and
inputs made with numpy, at the reduced whisper-medium and internvl2-26b
cards, fp32: the cross-attention (K and V from the encoder, S ≠ T) through
the flash kernel's plain version, its memory decode, the encoder, the
``cross_kv`` prefill writes, learned positions past their table, and the
serving engine's handling of both cards. Tolerance atol/rtol 1e-5 as in
``tests/test_torch_lm.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tcfg
from repro_torch.models import CausalLM, lm_params_from_numpy
from repro_torch.models.attention import Attention
from repro_torch.serving import ServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
WHISPER, INTERNVL = "whisper-medium", "internvl2-26b"


def _models(arch):
    jc = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32")
    tc = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
    params = jmodel.init_params(jax.random.PRNGKey(0), jc)
    model = CausalLM(tc, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tc, jax.tree.map(np.asarray, params)))
    return jc, params, tc, model


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["whisper", "qkv_bias"])
def test_cross_attention_matches_jax_at_s_not_t(qkv_bias):
    """S = 45 queries over T = 64 encoder rows: the full pass (flash plain
    version, non-causal, no window, no RoPE) against the JAX ``attention(
    kv_x=...)``; ``prefill_cross``'s memory against the JAX K/V; one decode
    token per row against the memory as the JAX ``decode_attention(
    kv_memory=...)``."""
    jc = jcfg.reduced(jcfg.get_config(WHISPER)).replace(dtype="float32", qkv_bias=qkv_bias)
    tc = tcfg.reduced(tcfg.get_config(WHISPER)).replace(dtype="float32", qkv_bias=qkv_bias)
    p = jax.tree.map(np.array, jattn.init_attention(jax.random.PRNGKey(3), jc, cross=True))
    rng = np.random.default_rng(3)
    if qkv_bias:  # the JAX init zeroes biases; make them count
        for name in p:
            p[name]["b"] = rng.standard_normal(p[name]["b"].shape).astype(np.float32)
    mod = Attention(tc, cross=True, device="cpu")
    mod.load_state_dict({f"{name}.{'weight' if leaf == 'w' else 'bias'}":
                         torch.from_numpy(np.ascontiguousarray(v.T if leaf == "w" else v))
                         for name, sub in p.items() for leaf, v in sub.items()})
    x = rng.standard_normal((2, 45, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jc.encoder_seq, jc.d_model)).astype(np.float32)
    want = jattn.attention(p, jc, jnp.asarray(x), kv_x=jnp.asarray(enc), causal=False)
    got = mod(torch.from_numpy(x), kv_x=torch.from_numpy(enc))
    np.testing.assert_allclose(_np(got), want, **TOL)

    memory = {k: torch.zeros(2, jc.encoder_seq, jc.num_kv_heads, jc.head_dim)
              for k in ("k", "v")}
    got = mod.prefill_cross(torch.from_numpy(x), torch.from_numpy(enc), memory)
    np.testing.assert_allclose(_np(got), want, **TOL)
    for name, w in (("k", "wk"), ("v", "wv")):
        kv = (enc @ p[w]["w"] + p[w].get("b", 0)).reshape(memory[name].shape)
        np.testing.assert_allclose(_np(memory[name]), kv, **TOL)
    x1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    want, _ = jattn.decode_attention(p, jc, jnp.asarray(x1), {}, jnp.int32(7),
                                     kv_memory={k: jnp.asarray(_np(v)) for k, v in memory.items()})
    got = mod.decode_memory(torch.from_numpy(x1), memory)
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_whisper_encoder_and_cross_kv_match_jax():
    """The encoder's output over seeded frames equals the JAX ``_encode``;
    prefill writes each cross layer's ``cross_kv`` as the JAX prefill does,
    and decode reads it."""
    jc, params, tc, model = _models(WHISPER)
    rng = np.random.default_rng(11)
    frames = rng.standard_normal((2, jc.encoder_seq, jc.d_model)).astype(np.float32)
    want = jmodel._encode(params, jc, jnp.asarray(frames))
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), want, **TOL)

    toks = rng.integers(0, jc.vocab_size, (2, 30)).astype(np.int32)
    want, jcache = jmodel.prefill(params, jc, jnp.asarray(toks), jmodel.init_cache(jc, 2, 40),
                                  frames=jnp.asarray(frames))
    tcache = model.init_cache(2, 40)
    got = model.prefill(torch.from_numpy(toks).long(), tcache, frames=torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), want, **TOL)
    for i, c in enumerate(tcache):
        assert c["cross_kv"]["k"].shape == (2, jc.encoder_seq, jc.num_kv_heads, jc.head_dim)
        for k in ("k", "v"):
            jkv = np.asarray(jcache["layers"][0]["cross_kv"][k])[i]   # period 1: repeat i
            np.testing.assert_allclose(_np(c["cross_kv"][k]), jkv, **TOL)
            assert float(np.abs(jkv).max()) > 0
    with pytest.raises(ValueError, match="frames="):
        model.prefill(torch.from_numpy(toks).long(), model.init_cache(2, 40))


def test_learned_positions_clamp_past_the_table():
    """Decode at positions 520 and 521, past the reduced card's 512 learned
    positions: both sides add the table's last row (and forward over 520
    tokens clamps the same way)."""
    jc, params, tc, model = _models(WHISPER)
    assert jc.learned_pos_emb == 512
    rng = np.random.default_rng(12)
    frames = rng.standard_normal((1, jc.encoder_seq, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, (1, 520)).astype(np.int32)
    _, jcache = jmodel.prefill(params, jc, jnp.asarray(toks), jmodel.init_cache(jc, 1, 530),
                               frames=jnp.asarray(frames))
    tcache = model.init_cache(1, 530)
    model.prefill(torch.from_numpy(toks).long(), tcache, frames=torch.from_numpy(frames))
    for pos in (520, 521):
        tok = rng.integers(0, jc.vocab_size, (1, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(params, jc, jnp.asarray(tok), jcache, jnp.int32(pos))
        got = model.decode_step(torch.from_numpy(tok).long(), tcache, pos)
        np.testing.assert_allclose(_np(got), want, **TOL)
    want, _ = jmodel.forward(params, jc, jnp.asarray(toks), frames=jnp.asarray(frames))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long(), frames=torch.from_numpy(frames))
    np.testing.assert_allclose(_np(got), want, **TOL)


def test_engine_refuses_the_encoder_decoder_card():
    _, _, tc, model = _models(WHISPER)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        ServingEngine(model, tc, max_batch=1, max_len=16, device="cpu")


def test_vlm_engine_keeps_the_reference_zero_rows():
    """The JAX engine prefills a VLM slot without patches yet counts
    ``num_patches`` in its length, so its first decode writes row
    ``P + num_patches`` and attends the zero rows ``[P, P + num_patches)``.
    The port's engine does the same: after one tick the rows between the
    prompt and the decoded token are still zero."""
    jc, params, tc, model = _models(INTERNVL)
    eng = ServingEngine(model, tc, max_batch=1, max_len=64, device="cpu")
    p, n = 20, tc.num_patches
    eng.submit(np.arange(1, p + 1, dtype=np.int32), max_new_tokens=3)
    eng.step()
    assert eng.lengths[0] == p + n + 1
    kv = eng.cache[0]["kv"]["k"][0]
    assert float(kv[:p].abs().min(dim=-1).values.max()) > 0      # the prompt's rows
    assert float(kv[p:p + n].abs().max()) == 0.0                  # the reference's gap
    assert float(kv[p + n].abs().max()) > 0                       # the first decode
