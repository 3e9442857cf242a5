"""LM training in the port (``repro_torch.train``, ``launch/train.py``, the
LM checkpoint, the two training examples) against the JAX package's, on the
JAX package's weights carried across by ``lm_params_from_numpy`` and
batches made with numpy.

Tolerances, stated once: every card is reduced and fp32. Losses and metrics
agree within rtol 1e-5 (the frameworks sum in different orders; the values
are O(1)); each gradient leaf within 2e-5 of the leaf's largest magnitude
(rtol 1e-4); learning rates within rtol 1e-6. Parameters after AdamW steps:
Adam's first step moves an element by lr · g / (|g| + eps), which is
ill-conditioned where |g| is within a few eps (1e-8) — there the fp32
summation noise of the gradient (~1e-7 of its leaf's largest element) moves
the element by up to ~0.15 lr, and later steps carry that on. So each leaf
is held on its displacement — from the start over free-running steps, and
over one step taken from the reference's own state (parameters and
moments) — in Frobenius norm, within ``DISP_TOL`` of the reference's
(measured: ≤ 5.1e-4 free-running, ≤ 1.3e-3 from the reference's state).
Remat changes no value: the three policies agree bit for bit on the CPU.
Checkpoints round-trip bit for bit, bf16 included.
"""
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint import load_checkpoint as jload
from repro.checkpoint import save_checkpoint as jsave
from repro.core.alignment import procrustes as jprocrustes
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro.train import loss as jloss
from repro.train import step as jstep
from repro_torch import configs as tcfg
from repro_torch.checkpoint import load_lm, save_lm
from repro_torch.models import CausalLM, init_params, lm_params_from_numpy, lm_params_to_numpy
from repro_torch.train import lm_loss, make_grad_fn, make_train_step, train_state_from_numpy

@pytest.fixture(autouse=True)
def _one_thread():
    """The reduced cards' tensors are small: one intra-op thread is as fast
    alone, and stays fast beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS = dict(rtol=1e-5, atol=1e-6)
DISP_TOL = 5e-3   # a leaf's displacement, relative to the reference's (Frobenius norm)
B, S = 2, 32


def _cfgs(arch, **kw):
    kw = {"dtype": "float32", **kw}
    return (jcfg.reduced(jcfg.get_config(arch)).replace(**kw),
            tcfg.reduced(tcfg.get_config(arch)).replace(**kw))


_jax_init = jax.jit(jmodel.init_params, static_argnums=1)


def _carried(arch, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port model with the same weights):
    weights drawn by the port's ``init_params`` (the JAX package's laws,
    and far quicker than its eager ``jax.random`` init), given to the
    reference as its tree by ``lm_params_to_numpy`` and carried back into a
    fresh model by ``lm_params_from_numpy``. The reference runs without
    remat, which changes no value and compiles faster; the port keeps the
    card's ``remat``."""
    jc, tc = _cfgs(arch, **kw)
    jc = jc.replace(remat=False)
    tree = lm_params_to_numpy(tc, init_params(tc, torch.Generator().manual_seed(seed),
                                              device="cpu"))
    model = CausalLM(tc, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tc, tree))
    return jc, jax.tree.map(jnp.asarray, tree), tc, model


def _batch(jc, rng, b=B, s=S):
    """numpy batch: tokens, labels (the first three of row 0 masked), and
    the card's frames or patches."""
    out = {"tokens": rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if jc.encoder_layers:
        out["frames"] = rng.standard_normal((b, jc.encoder_seq, jc.d_model)).astype(np.float32)
    if jc.num_patches:
        out["patches"] = rng.standard_normal((b, jc.num_patches, jc.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels") else torch.from_numpy(v)
            for k, v in batch.items()}


def _grad_tree(tc, grads):
    """Gradients keyed by parameter name → the reference's tree layout."""
    holder = CausalLM(tc, device="cpu")
    with torch.no_grad():
        for name, p in holder.named_parameters():
            p.copy_(grads[name])
    return lm_params_to_numpy(tc, holder)


def _assert_trees(got, want, atol_frac=2e-5, rtol=1e-4):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * max(np.abs(w).max(), 1e-30))


def _jax_loss(jc, params, batch, grad=True, **kw):
    extra = {k: jnp.asarray(batch[k]) for k in ("frames", "patches") if k in batch}

    def f(p):
        return jloss.lm_loss(p, jc, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
                             **extra, **kw)
    return jax.jit(jax.value_and_grad(f, has_aux=True) if grad else f)(params)


# ------------------------------------------------------------ loss and grad
@pytest.mark.parametrize("arch", sorted(jcfg.ARCHS))
def test_lm_loss_and_grad_match_jax(arch):
    """Every card: the loss (chunked CE, z-loss, masked labels, the MoE aux,
    a VLM's token positions only) and its gradient against the reference."""
    jc, params, tc, model = _carried(arch)
    batch = _batch(jc, np.random.default_rng(1))
    (jl, jm), jg = _jax_loss(jc, params, batch, ce_chunk=16, z_loss=1e-4)
    tb = _torch_batch(batch)
    loss, metrics = lm_loss(model, tc, tb["tokens"], tb["labels"], frames=tb.get("frames"),
                            patches=tb.get("patches"), ce_chunk=16, z_loss=1e-4)
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS)
    for k in ("nll", "aux", "z"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), **LOSS)
    if tc.moe.enabled:
        assert metrics["aux"].item() > 0
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True, materialize_grads=True)
    _assert_trees(_grad_tree(tc, dict(zip(names, grads))), jg)


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_ce_chunk_and_z_loss_match_jax(z_loss):
    """ce_chunk 0 against 16 (and 12, which does not divide S: the whole
    logits, as in the reference), each against the reference."""
    jc, params, tc, model = _carried("qwen3-0.6b")
    batch = _batch(jc, np.random.default_rng(2))
    batch["labels"][1, -5:] = -1
    tb = _torch_batch(batch)
    losses = []
    for ce in (0, 16, 12):
        jl, jm = _jax_loss(jc, params, batch, grad=False, ce_chunk=ce, z_loss=z_loss)
        loss, m = lm_loss(model, tc, tb["tokens"], tb["labels"], ce_chunk=ce, z_loss=z_loss)
        np.testing.assert_allclose(loss.item(), float(jl), **LOSS)
        np.testing.assert_allclose(m["z"].item(), float(jm["z"]), **LOSS)
        assert (m["z"].item() > 0) == (z_loss > 0)
        losses.append(loss.item())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)


# ------------------------------------------------------------ the train step
STEP_CASES = [("qwen3-0.6b", 1, 0), ("qwen3-0.6b", 2, 16), ("mixtral-8x22b", 2, 0)]


@pytest.mark.parametrize("arch,mb,ce", STEP_CASES,
                         ids=[f"{a}-mb{m}-ce{c}" for a, m, c in STEP_CASES])
def test_train_step_matches_jax(arch, mb, ce):
    """Three steps of ``make_train_step`` against ``jax.jit(make_train_step)``
    from the same weights and batches: the metrics of every step and each
    leaf's displacement from the start; and at steps 2 and 3 a port state
    carried from the reference's (parameters and AdamW moments) takes the
    step as the reference does."""
    jc, params, tc, model = _carried(arch)
    tr = tcfg.TrainConfig(global_batch=4, seq_len=S, microbatches=mb, ce_chunk=ce,
                          learning_rate=3e-3, warmup_steps=1, total_steps=3, z_loss=1e-4)
    jstate = jstep.TrainState(params, jadamw_init(params))
    start = jax.tree.map(np.asarray, params)
    jtrain = jax.jit(jstep.make_train_step(jc, jcfg.TrainConfig(**tr.__dict__)))
    state = train_state_from_numpy(tc, start, device="cpu")
    step = make_train_step(tc, tr)
    rng = np.random.default_rng(3)
    for i in range(3):
        batch = _batch(jc, rng, b=4)
        forced = None
        if i:
            before = jax.tree.map(np.asarray, jstate.params)
            forced = train_state_from_numpy(tc, before, jax.tree.map(np.asarray, jstate.opt),
                                            device="cpu")
            forced, fm = step(forced, _torch_batch(batch))
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, _torch_batch(batch))
        assert set(m) == set(jm) == {"nll", "aux", "z", "loss", "lr"}
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
        for k in ("nll", "aux", "z", "loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **LOSS)
        assert int(state.opt.step) == int(jstate.opt.step) == i + 1
        want = jax.tree.leaves(jstate.params)
        for g, w, p0 in zip(jax.tree.leaves(lm_params_to_numpy(tc, state.model)), want,
                            jax.tree.leaves(start)):
            dw = np.asarray(w) - p0
            assert np.linalg.norm((g - p0) - dw) <= DISP_TOL * np.linalg.norm(dw)
        if forced is not None:
            for k in ("nll", "aux", "z", "loss"):
                np.testing.assert_allclose(float(fm[k]), float(jm[k]), **LOSS)
            for g, w, p0 in zip(jax.tree.leaves(lm_params_to_numpy(tc, forced.model)), want,
                                jax.tree.leaves(before)):
                dw = np.asarray(w) - p0
                assert np.linalg.norm((g - p0) - dw) <= DISP_TOL * np.linalg.norm(dw)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b", "whisper-medium"])
def test_remat_policies_give_equal_losses_and_grads(arch):
    """``remat`` off, ``full`` and ``dots`` (the encoder's layers too): the
    same loss and gradients, bit for bit."""
    out = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        jc, _, tc, model = _carried(arch, remat=remat, remat_policy=policy)
        batch = _torch_batch(_batch(jc, np.random.default_rng(4)))
        tr = tcfg.TrainConfig(global_batch=B, seq_len=S, microbatches=1, ce_chunk=16)
        loss, _, grads = make_grad_fn(tc, tr)(model, batch)
        out.append((loss, grads))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for k, g in grads.items():
            assert torch.equal(g, out[0][1][k]), k


def test_return_hidden_is_the_reference_forward():
    jc, params, tc, model = _carried("internvl2-26b")
    batch = _batch(jc, np.random.default_rng(5))
    want, jaux = jmodel.forward(params, jc, jnp.asarray(batch["tokens"]),
                                patches=jnp.asarray(batch["patches"]), return_hidden=True)
    with torch.no_grad():
        h, aux = model(torch.from_numpy(batch["tokens"]).long(),
                       patches=torch.from_numpy(batch["patches"]), return_hidden=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert h.shape == (B, jc.num_patches + S, jc.d_model) and float(aux) == float(jaux) == 0.0


# ------------------------------------------------------------ checkpoints
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_checkpoint_loads_both_ways(tmp_path, dtype):
    """A checkpoint written by the reference loads into the port bit for
    bit; one written by the port holds the reference's keys, dtypes and
    bytes, and ``repro.checkpoint.load_checkpoint`` reads it (bf16 leaves,
    stored as ``|V2`` by both, read back as their bytes: the reference's
    loader cannot cast ``|V2`` to bfloat16, its own files included)."""
    jc, tc = _cfgs("jamba-1.5-large-398b", dtype=dtype)
    params = _jax_init(jax.random.PRNGKey(7), jc)
    jsave(str(tmp_path / "jax.npz"), params, metadata={"arch": jc.name})
    model = CausalLM(tc, device="cpu")
    assert load_lm(str(tmp_path / "jax.npz"), tc, model) == {"arch": jc.name}
    carried = lm_params_to_numpy(tc, model)
    assert jax.tree.structure(carried) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(carried), jax.tree.leaves(params)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))

    save_lm(str(tmp_path / "port.npz"), tc, model, metadata={"arch": jc.name})
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__metadata__":
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    like = jax.tree.map(lambda x: np.empty(x.shape, "V2") if x.dtype == jnp.bfloat16
                        else jax.ShapeDtypeStruct(x.shape, x.dtype), params)
    tree, meta = jload(str(tmp_path / "port.npz"), like)
    assert meta == {"arch": jc.name}
    for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            g = g.view(ml_dtypes.bfloat16)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    fresh = init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    load_lm(str(tmp_path / "port.npz"), tc, fresh)
    for (k, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k


# ------------------------------------------------------------ launch/train
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_launch_train_batches_extras_and_checkpoint(arch, tmp_path, monkeypatch, capsys):
    """``launch/train.py`` feeds the reference script's batches and stubbed
    frames/patches, trains on the CPU, and its checkpoint loads into the
    reference, whose loss on it equals the port's."""
    import repro.launch.train as jtrain
    from repro_torch.launch import train as ttrain

    seen = []

    def fake_step(state, b):
        seen.append({k: np.asarray(v) for k, v in b.items()})
        return state, {"loss": 0.0, "lr": 0.0}

    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2", "--seq-len", "16",
            "--log-every", "1", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    monkeypatch.setattr(jtrain, "init_train_state", lambda key, cfg: None)
    monkeypatch.setattr(jtrain, "make_train_step", lambda cfg, tcfg: fake_step)
    monkeypatch.setattr(jtrain.jax, "jit", lambda f: f)
    jtrain.main()
    monkeypatch.undo()
    cfg = tcfg.reduced(tcfg.get_config(arch)).replace(dtype="float32")
    ours = list(ttrain.batches(cfg, batch=2, seq_len=16, steps=2, seed=3))
    assert len(ours) == len(seen) == 2
    for a, b in zip(ours, seen):
        assert sorted(a) == sorted(b)
        for k in a:
            t = ttrain.to_device(a, cfg, torch.device("cpu"))[k]
            np.testing.assert_array_equal(t.numpy(), b[k].astype(t.numpy().dtype))

    ckpt = str(tmp_path / "train.npz")
    res = ttrain.main(argv + ["--device", "cpu", "--checkpoint", ckpt])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert "final loss" in capsys.readouterr().out
    jc = jcfg.reduced(jcfg.get_config(arch)).replace(dtype="float32")
    like = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc))
    tree, meta = jload(ckpt, like)
    assert meta == {"arch": jc.name, "steps": 2}
    b = ours[0]
    extra = {k: jnp.asarray(b[k], jnp.float32) for k in ("frames", "patches") if k in b}
    jl, _ = jloss.lm_loss(tree, jc, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), **extra)
    tb = ttrain.to_device(b, cfg, torch.device("cpu"))
    with torch.no_grad():
        tl, _ = lm_loss(res["state"].model, cfg, tb["tokens"], tb["labels"],
                        frames=tb.get("frames"), patches=tb.get("patches"))
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS)


# ------------------------------------------------------------ examples
def test_federated_lm_example_aggregates_row_for_row():
    """``examples/federated_lm_embeddings_torch.py`` at a cut size: the
    parties train, PPAT's ε is finite, the host's refinement is the
    reference's procrustes of the same synthesized rows, and the aggregation
    writes ``0.5 · (y + refined)`` into exactly the aligned rows, as the
    reference's ``table.at[idx].set(...)``."""
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]
                           / "examples"))
    try:
        import federated_lm_embeddings_torch as ex
    finally:
        sys.path.pop(0)
    res = ex.main(["--device", "cpu", "--steps", "3", "--ppat-steps", "8",
                   "--retrain-steps", "2"])
    assert np.isfinite([res["loss_a"], res["loss_b"], res["epsilon"], res["before"],
                        res["after"]]).all()
    assert res["kept"] == (res["after"] <= res["before"])
    synth, y = res["synth"].numpy(), res["y"].numpy()
    want = synth @ np.asarray(jprocrustes(jnp.asarray(synth), jnp.asarray(y)))
    np.testing.assert_allclose(res["refined"].numpy(), want, atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(6)
    table = rng.standard_normal((300, y.shape[1])).astype(np.float32)
    idx = res["idx"].numpy()
    refined = res["refined"].numpy()
    jt = np.asarray(jnp.asarray(table).at[idx].set((0.5 * (jnp.asarray(y) + refined))
                                                   .astype(jnp.float32)))
    tt = torch.from_numpy(table.copy())
    ex.aggregate(tt, torch.from_numpy(idx), torch.from_numpy(y), torch.from_numpy(refined))
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tt.numpy()[len(idx):], table[len(idx):])
