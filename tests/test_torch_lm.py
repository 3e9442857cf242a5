"""The port's LM substrate (configs, data pipeline, attention, Mamba2, the
model) against the JAX package's, on the JAX package's own weights carried
across by ``lm_params_from_numpy`` and inputs made with numpy.

Every card is reduced (``reduced(get_config(...))``, 2 layers) and run at
fp32. Activations and logits agree within atol 1e-5 / rtol 1e-5: the two
frameworks sum in different orders, and the values are O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data import pipeline as jdata
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import configs as tcfg
from repro_torch.data import pipeline as tdata
from repro_torch.models import CausalLM, init_params, lm_params_from_numpy
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.ssm import Mamba2Mixer, init_ssm_cache

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch, **kw):
    j = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32", **kw)
    t = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32", **kw)
    return j, t


def _jax_model(arch, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port model carrying the same weights)."""
    jc, tc = _cfgs(arch, **kw)
    params = jmodel.init_params(jax.random.PRNGKey(seed), jc)
    model = CausalLM(tc, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tc, jax.tree.map(np.asarray, params)))
    return jc, params, tc, model


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------- configs, data
@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_configs_equal_field_for_field(arch):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jcfg.reduced(j)) == dataclasses.asdict(tcfg.reduced(t))
    assert j.param_count() == t.param_count() and j.padded_vocab == t.padded_vocab


def test_config_defaults_and_shapes_equal():
    for name in ("TrainConfig", "ServeConfig", "MoEConfig", "SSMConfig"):
        assert dataclasses.asdict(getattr(jcfg, name)()) == \
            dataclasses.asdict(getattr(tcfg, name)())
    assert [dataclasses.asdict(s) for s in jcfg.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in tcfg.INPUT_SHAPES]
    assert round(tcfg.get_config("qwen3-0.6b").param_count() / 1e9, 3) == 0.596
    assert round(tcfg.get_config("mamba2-2.7b").param_count() / 1e9, 2) == 2.70


def test_synthetic_text_bit_equal():
    for vocab, seed in ((151_936, 0), (512, 3)):
        j, t = jdata.SyntheticTextDataset(vocab, seed=seed), \
            tdata.SyntheticTextDataset(vocab, seed=seed)
        np.testing.assert_array_equal(j.tokens(700, seed=5), t.tokens(700, seed=5))
        for a, b in zip(jdata.make_batches(j, batch=2, seq_len=33, steps=2, seed=1),
                        tdata.make_batches(t, batch=2, seq_len=33, steps=2, seed=1)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            np.testing.assert_array_equal(a["labels"], b["labels"])
    text = "héllo, 世界"
    assert jdata.ByteTokenizer().encode(text).tolist() == tdata.ByteTokenizer().encode(text).tolist()
    assert tdata.ByteTokenizer().decode(tdata.ByteTokenizer().encode(text)) == text


# ------------------------------------------------------------------ attention
ATTN_VARIANTS = {"qwen3": {}, "window16": {"sliding_window": 16}, "qkv_bias": {"qkv_bias": True}}


def _attention(variant, seed=0):
    jc, tc = _cfgs("qwen3-0.6b", **ATTN_VARIANTS[variant])
    p = jattn.init_attention(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    if jc.qkv_bias:  # the JAX init zeroes biases; make them count
        for k in ("wq", "wk", "wv", "wo"):
            p[k]["b"] = jnp.asarray(rng.standard_normal(p[k]["b"].shape).astype(np.float32))
    mod = Attention(tc, device="cpu")
    flat = {}
    for name, sub in p.items():
        for leaf, v in sub.items():
            v = np.asarray(v)
            if leaf == "w":
                flat[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(v.T))
            elif leaf == "b":
                flat[f"{name}.bias"] = torch.from_numpy(v.copy())
            else:
                flat[f"{name}.{leaf}"] = torch.from_numpy(v)
    mod.load_state_dict(flat)
    return jc, p, tc, mod, rng


@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_attention_and_prefill_match_jax(variant):
    jc, p, tc, mod, rng = _attention(variant)
    x = rng.standard_normal((2, 45, jc.d_model)).astype(np.float32)
    want = jattn.attention(p, jc, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **TOL)
    jcache = jattn.init_kv_cache(jc, 2, 64, jnp.float32)
    want, jcache = jattn.prefill_attention(p, jc, jnp.asarray(x), jcache)
    tcache = init_kv_cache(tc, 2, 64, torch.float32)
    got = mod.prefill(torch.from_numpy(x), tcache)
    np.testing.assert_allclose(_np(got), want, **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[k]), jcache[k], **TOL)


@pytest.mark.parametrize("variant", sorted(ATTN_VARIANTS))
def test_decode_with_per_slot_positions_matches_jax(variant):
    """One batched decode over slots at positions (45, 20, 63) against the
    JAX ``decode_attention`` run on each slot alone at its position — what
    the JAX engine gets by vmap over single-slot decodes."""
    jc, p, tc, mod, rng = _attention(variant, seed=1)
    pos = np.array([45, 20, 63])
    cache = {k: rng.standard_normal((3, 64, jc.num_kv_heads, jc.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((3, 1, jc.d_model)).astype(np.float32)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got = mod.decode(torch.from_numpy(x), tcache, torch.from_numpy(pos))
    for b in range(3):
        jc1 = {k: jnp.asarray(v[b:b + 1]) for k, v in cache.items()}
        want, jc1 = jattn.decode_attention(p, jc, jnp.asarray(x[b:b + 1]), jc1,
                                           jnp.int32(pos[b]))
        np.testing.assert_allclose(_np(got[b:b + 1]), want, **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[k][b:b + 1]), jc1[k], **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_flash_path_matches_jax_chunked_scan(causal, window):
    """The JAX package's XLA flash scan (used above 8,192 tokens) at small
    chunks, against the port's flash-attention path at 100 tokens."""
    from repro_torch.kernels.flash_attention import flash_attention

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 100, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 100, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 100, 2, 32)).astype(np.float32)
    want = jattn._chunked_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, window=window,
                                        scale=1.0 / np.sqrt(32), q_chunk=20, k_chunk=25)
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    got = flash_attention(*t, causal=causal, window=window).transpose(1, 2).reshape(2, 100, -1)
    np.testing.assert_allclose(_np(got), want, **TOL)


# ---------------------------------------------------------------------- SSM
def _mixer(seed=0):
    jc, tc = _cfgs("mamba2-2.7b")
    p = jssm.init_ssm(jax.random.PRNGKey(seed), jc)
    mod = Mamba2Mixer(tc, device="cpu")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in p.items()
          if k not in ("in_proj", "out_proj")}
    sd["in_proj.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["in_proj"]).T))
    sd["out_proj.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(p["out_proj"]).T))
    mod.load_state_dict(sd)
    return jc, p, tc, mod


@pytest.mark.parametrize("s", [2, 75])
def test_ssm_prefill_then_decode_matches_jax(s):
    """``ssm_prefill`` (a ragged length is padded to a chunk with dt = 0)
    and two ``ssm_decode_step``s after it: outputs and caches."""
    jc, p, tc, mod = _mixer()
    rng = np.random.default_rng(s)
    u = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    want, jcache = jssm.ssm_prefill(p, jc, jnp.asarray(u), jssm.init_ssm_cache(jc, 2,
                                                                                jnp.float32))
    tcache = init_ssm_cache(tc, 2, torch.float32)
    got = mod.prefill(torch.from_numpy(u), tcache)
    np.testing.assert_allclose(_np(got), want, **TOL)
    for _ in range(2):
        for k in ("state", "conv"):
            np.testing.assert_allclose(_np(tcache[k]), jcache[k], atol=1e-4, rtol=1e-5)
        x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        want, jcache = jssm.ssm_decode_step(p, jc, jnp.asarray(x), jcache)
        got = mod.decode(torch.from_numpy(x), tcache)
        np.testing.assert_allclose(_np(got), want, **TOL)


def test_ssm_block_matches_jax():
    jc, p, tc, mod = _mixer(1)
    u = np.random.default_rng(0).standard_normal((1, 64, jc.d_model)).astype(np.float32)
    want, wstate = jssm.ssm_block(p, jc, jnp.asarray(u))
    got, state = mod(torch.from_numpy(u))
    np.testing.assert_allclose(_np(got), want, **TOL)
    np.testing.assert_allclose(_np(state), wstate, atol=1e-4, rtol=1e-5)


# -------------------------------------------------------------------- model
MODEL_CASES = [("qwen3-0.6b", {}), ("qwen3-0.6b", {"sliding_window": 16, "qkv_bias": True}),
               ("mamba2-2.7b", {}), ("starcoder2-15b", {}),   # the last: LayerNorm, gelu
               ("mixtral-8x22b", {}), ("kimi-k2-1t-a32b", {}),  # MoE; kimi's shared expert
               ("jamba-1.5-large-398b", {}),                    # Mamba2 + attention + MoE
               ("internvl2-26b", {}), ("whisper-medium", {})]   # seeded patches; frames


def _extra_inputs(jc, rng, b):
    """Seeded frames (enc-dec) and patches (VLM) for a card, for both sides."""
    jkw, tkw = {}, {}
    if jc.encoder_layers:
        fr = rng.standard_normal((b, jc.encoder_seq, jc.d_model)).astype(np.float32)
        jkw["frames"], tkw["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    if jc.num_patches:
        pa = rng.standard_normal((b, jc.num_patches, jc.d_model)).astype(np.float32)
        jkw["patches"], tkw["patches"] = jnp.asarray(pa), torch.from_numpy(pa)
    return jkw, tkw


@pytest.mark.parametrize("arch,kw", MODEL_CASES, ids=lambda v: str(v))
def test_model_prefill_decode_and_forward_match_jax(arch, kw):
    """Prefill (behind the patches, against the frames' encoding), two
    decode steps after the prefix, and forward: logits, and forward's
    summed MoE aux loss (within 1e-6)."""
    jc, params, tc, model = _jax_model(arch, **kw)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (2, 45)).astype(np.int32)
    jkw, tkw = _extra_inputs(jc, rng, 2)
    n = jc.num_patches + 45   # rows prefill writes
    want, jcache = jmodel.prefill(params, jc, jnp.asarray(toks),
                                  jmodel.init_cache(jc, 2, n + 19), **jkw)
    tcache = model.init_cache(2, n + 19)
    got = model.prefill(torch.from_numpy(toks).long(), tcache, **tkw)
    np.testing.assert_allclose(_np(got), want, **TOL)
    for i in range(2):
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(params, jc, jnp.asarray(tok), jcache, jnp.int32(n + i))
        got = model.decode_step(torch.from_numpy(tok).long(), tcache, n + i)
        np.testing.assert_allclose(_np(got), want, **TOL)
    want, want_aux = jmodel.forward(params, jc, jnp.asarray(toks[:, :32]), **jkw)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(toks[:, :32]).long(), return_aux=True, **tkw)
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert (float(want_aux) > 0) == jc.moe.enabled


def test_weights_map_layer_i_to_repeat_and_position():
    """Every parameter of the port is set by the loader, and layer ``i``
    carries repeat ``i // period`` of period position ``i % period``."""
    jc, params, tc, model = _jax_model("qwen3-0.6b")
    sd = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params))
    assert set(sd) == set(model.state_dict())
    w = np.asarray(params["layers"][0]["attn"]["wq"]["w"])
    for i in range(tc.num_layers):
        np.testing.assert_array_equal(sd[f"layers.{i}.attn.wq.weight"].numpy(), w[i].T)


@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_loader_sets_every_parameter(arch):
    """``lm_params_from_numpy`` of the JAX ``init_params`` tree names every
    parameter of the port's reduced card, at its shape, and nothing else:
    the MoE experts, the encoder's stack, learned positions, the patch
    projection and the cross-attention included."""
    jc, tc = _cfgs(arch)
    params = jmodel.init_params(jax.random.PRNGKey(0), jc)
    model = CausalLM(tc, device="cpu")
    sd = lm_params_from_numpy(tc, jax.tree.map(np.asarray, params))
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(sd[k].shape == want[k].shape for k in want)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax


def test_init_params_laws_and_unported_cards():
    """The port's own init draws from a ``torch.Generator`` with the JAX
    package's laws — Mamba2's, and for the MoE, encoder and patch cards
    (mixtral, whisper, internvl) the router and experts, learned positions,
    the frame and patch projections; every card builds."""
    cfg = tcfg.reduced(tcfg.get_config("mamba2-2.7b")).replace(dtype="float32", d_model=256)
    m = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mix = m.layers[0].ssm
    d = cfg.d_model
    m.requires_grad_(False)
    assert abs(float(m.embed.weight.std()) - 0.02) < 1e-3
    assert abs(float(mix.in_proj.weight.std()) * np.sqrt(d) - 1) < 0.02
    assert abs(float(mix.conv_w.std()) - 0.1) < 0.01
    np.testing.assert_allclose(_np(mix.A_log), np.log(np.arange(1, mix.A_log.numel() + 1)))
    dt = torch.nn.functional.softplus(mix.dt_bias)
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))

    def law(t, std, tol=0.03):
        return abs(float(t.std()) / std - 1) < tol

    for arch in ("mixtral-8x22b", "whisper-medium", "internvl2-26b"):
        cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
        m = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        m.requires_grad_(False)
        d = cfg.d_model
        assert law(m.embed.weight, 0.02)
        if cfg.moe.enabled:
            moe = m.layers[0].moe
            assert moe.router.dtype == torch.float32 and law(moe.router, d ** -0.5, 0.1)
            assert law(moe.w_gate, d ** -0.5) and law(moe.w_up, d ** -0.5)
            assert law(moe.w_down, cfg.moe.d_ff ** -0.5)
        if cfg.learned_pos_emb:
            assert m.pos_emb.shape == (cfg.learned_pos_emb, d) and law(m.pos_emb, 0.02)
            assert law(m.encoder.frame_proj.weight, d ** -0.5)
            assert law(m.encoder.layers[1].attn.wq.weight, d ** -0.5)
            assert law(m.layers[0].cross_attn.wk.weight, d ** -0.5)
            assert float(m.layers[0].norm_cross.scale.min()) == 1.0
        if cfg.num_patches:
            assert law(m.patch_proj.weight, d ** -0.5)
    for arch in sorted(tcfg.ARCHS):
        CausalLM(tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32"), device="cpu")
