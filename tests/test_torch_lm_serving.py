"""The port's LM ``ServingEngine`` and serving script against the JAX
package's, on the JAX package's weights (``lm_params_from_numpy``), for the
reduced qwen3-0.6b and mamba2-2.7b, mixtral-8x22b and jamba (MoE, routed per
slot in the engine), internvl2-26b (the patch prefix) and, in the serving
script only, whisper-medium (frames), at fp32.

Greedy tokens are equal up to near-ties: streams agree until their first
difference, where the port's batch-1 logits of the two tokens lie within
1e-4 (the models' logits agree within 1e-5; ``tests/test_torch_lm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_check import assert_tokens_match, batch1_greedy
from repro import configs as jcfg
from repro.models import model as jmodel
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import CausalLM, lm_params_from_numpy
from repro_torch.serving import ServingEngine

ARCHS = ["qwen3-0.6b", "mamba2-2.7b", "mixtral-8x22b", "jamba-1.5-large-398b",
         "internvl2-26b"]
SERVE_ARCHS = ["qwen3-0.6b", "mamba2-2.7b", "mixtral-8x22b", "internvl2-26b",
               "whisper-medium"]
PROMPT_LENS = (5, 37, 20, 90)   # ragged; 90 is no multiple of mamba's 32-token chunk
NEW_TOKENS = (6, 9, 4, 7)


def _models(arch):
    jc = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32")
    tc = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
    params = jmodel.init_params(jax.random.PRNGKey(0), jc)
    model = CausalLM(tc, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tc, jax.tree.map(np.asarray, params)))
    return jc, params, tc, model


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """Four requests through two slots (so slots are recycled mid-run and
    decode at different positions): the port's batched tick and the JAX
    engine's vmap over single-slot decodes give the same tokens, and so
    does a batch-1 run of each prompt alone. A VLM slot decodes
    ``num_patches`` rows past its patch-less prefill and attends the rows
    between (both engines): zeros in a fresh slot, as in the batch-1 run
    offset by ``num_patches``, but the previous request's K/V in a recycled
    one, where the two engines' tokens are held equal to each other."""
    jc, params, tc, model = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jc.vocab_size, n).astype(np.int32) for n in PROMPT_LENS]
    jeng = JaxServingEngine(params, jc, max_batch=2, max_len=128)
    teng = ServingEngine(model, tc, max_batch=2, max_len=128, device="cpu")
    for p, n in zip(prompts, NEW_TOKENS):
        assert jeng.submit(p, max_new_tokens=n) == teng.submit(p, max_new_tokens=n)
    want = {r.rid: r.generated for r in jeng.run_until_drained()}
    done = teng.run_until_drained()
    assert len(done) == len(prompts) and all(r.done for r in done)
    assert not teng.queue and all(r is None for r in teng.slot_req)
    assert (teng.lengths == 0).all()
    for r in done:
        assert len(r.generated) == NEW_TOKENS[r.rid]
        assert r.finished_at >= r.submitted_at
        if tc.num_patches and r.rid >= teng.max_batch:   # a recycled VLM slot
            assert r.generated == want[r.rid]
            continue
        ref, logits = batch1_greedy(model, prompts[r.rid], NEW_TOKENS[r.rid],
                                    offset=tc.num_patches)
        assert_tokens_match(r.generated, ref, logits, 1e-4)
        assert_tokens_match(want[r.rid], ref, logits, 1e-4)


def test_engine_refuses_what_the_cache_cannot_hold():
    _, _, tc, model = _models("qwen3-0.6b")
    eng = ServingEngine(model, tc, max_batch=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(np.zeros(10, np.int32), max_new_tokens=7)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.zeros(0, np.int32))
    assert eng.submit(np.zeros(10, np.int32), max_new_tokens=6) == 0
    assert len(eng.run_until_drained()[0].generated) == 6


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_script_matches_jax_greedy_loop(arch):
    """``launch/serve.py``'s batched prefill + decode (behind seeded patches,
    against seeded frames) against the same loop over the JAX package's
    ``prefill``/``decode_step``, up to near-ties of the JAX logits; and,
    where nothing couples the rows (no MoE, whose capacity counts the
    batch's tokens), each row against a batch-1 run of its own."""
    jc, params, tc, model = _models(arch)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jc.vocab_size, (3, 40)).astype(np.int32)
    gen = 6
    jkw, tkw = {}, {}
    if jc.encoder_layers:
        fr = rng.standard_normal((3, jc.encoder_seq, jc.d_model)).astype(np.float32)
        jkw["frames"], tkw["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    if jc.num_patches:
        pa = rng.standard_normal((3, jc.num_patches, jc.d_model)).astype(np.float32)
        jkw["patches"], tkw["patches"] = jnp.asarray(pa), torch.from_numpy(pa)
    off = jc.num_patches
    got, times = tserve.generate(model, prompts, gen, **tkw)
    assert got.shape == (3, gen) and times["prefill_s"] > 0
    cache = jmodel.init_cache(jc, 3, off + 40 + gen)
    logits, cache = jmodel.prefill(params, jc, jnp.asarray(prompts), cache, **jkw)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want, want_logits = [np.asarray(tok)], [np.asarray(logits[:, -1])]
    for i in range(gen - 1):
        logits, cache = jmodel.decode_step(params, jc, tok, cache, jnp.int32(off + 40 + i))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        want_logits.append(np.asarray(logits[:, -1]))
    want = np.concatenate(want, axis=1)
    want_logits = np.stack(want_logits, axis=1)
    for b in range(3):
        assert_tokens_match(got[b], want[b], want_logits[b], 1e-4)
        if jc.moe.enabled:
            continue
        ref, lg = batch1_greedy(model, prompts[b], gen, offset=off,
                                **{k: v[b:b + 1] for k, v in tkw.items()})
        assert_tokens_match(got[b], ref, lg, 1e-4)
        assert_tokens_match(want[b], ref, lg, 1e-4)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "mamba2-2.7b", "--reduced", "--batch", "2", "--prompt-len", "9",
                 "--gen", "3", "--device", "cpu", "--temperature", "0.7"])
    out = capsys.readouterr().out
    assert "arch=mamba2-2.7b batch=2 prompt=9 gen=3 device=cpu" in out
    assert "seq1:" in out


def test_engine_without_device_raises_without_cuda(monkeypatch):
    _, _, tc, model = _models("qwen3-0.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, tc, max_batch=1, max_len=16)


def test_serve_engine_example_runs_on_the_cpu(capsys):
    """``examples/serve_engine_torch.py --device cpu`` on a reduced MoE card:
    every request drained with its token count."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "serve_engine_torch.py"
    spec = importlib.util.spec_from_file_location("serve_engine_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    done = example.main(["--arch", "mixtral-8x22b", "--requests", "4", "--slots", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=mixtral-8x22b slots=2 requests=4 device=cpu" in out
    assert sorted(len(r.generated) for r in done) == [8, 8, 12, 12]
    assert "drained 40 tokens" in out
