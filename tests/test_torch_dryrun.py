"""The port's dry-run (``repro_torch.launch.dryrun``): the step of a card on
a fake group of 256 ranks, shapes only, against what the JAX package's
dry-run lays out.

* qwen3-0.6b × decode_32k on the production (16, 16) mesh: ``ok``, 256
  ranks, a peak, and a bottleneck verdict — the counterpart of
  ``test_dryrun_entrypoint_one_combo``.
* Its per-rank argument bytes equal the sum of the reference's
  ``NamedSharding(mesh, spec).shard_shape`` bytes over the same arguments,
  from a 512-device JAX subprocess that builds the workload without
  compiling it.
* A reduced qwen3 train step on a fake (2, 4) mesh reports collectives —
  the counterpart of ``test_small_mesh_lower_compile_and_collectives``.
* The same program on real ranks computes the one-process numbers: reduced
  qwen3 (heads over ``model``, its 2 KV heads whole; the CE in chunks with
  a z-loss), kimi (the MoE's all-to-all form), mamba2 (the SSD), mixtral
  and a 16-expert kimi on the gather path (the two expert layouts),
  whisper (frames, cross-attention and its memory) and internvl (patches)
  on 8 gloo ranks of a (2, 4) mesh, fp32 — loss, logits, NLL and every
  gradient, prefill and a decode step against a cache split over the
  sequence — within 1e-5 (relative to the largest value for gradients).
  The all-to-all MoE runs at capacity factor 16 with no aux weight:
  per-rank capacities and the per-rank aux are what the all-to-all form
  changes (as the reference's does); the gather path keeps the card's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from _torch_ranks import sharded_lm_rank
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core import parties
from repro_torch.launch.dryrun import dryrun_one, fake_group
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.workloads import make_workload
from repro_torch.models.model import init_params
from repro_torch.sharding import context as shard_ctx
from repro_torch.train.loss import lm_loss
from repro_torch.utils.collectives import RankAccounting

REPO = pathlib.Path(__file__).resolve().parents[1]

REFERENCE_ARG_BYTES = r"""
import json
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs.registry import get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.workloads import make_workload

wl = make_workload(get_config("qwen3-0.6b"), "decode_32k", make_production_mesh())
args = jax.tree.leaves(wl["args"])
shardings = jax.tree.leaves(wl["in_shardings"], is_leaf=lambda x: isinstance(x, NamedSharding))
assert len(args) == len(shardings)
total = sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
            for a, s in zip(args, shardings))
print(json.dumps({"bytes": total, "leaves": len(args)}))
"""


def test_dryrun_decode_on_the_production_mesh():
    r = dryrun_one("qwen3-0.6b", "decode_32k", multi_pod=False, verbose=False)
    assert r["status"] == "ok", r
    assert r["chips"] == 256
    assert r["memory"]["peak_bytes_per_device"] > r["memory"]["argument_bytes_per_device"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert r["collectives"]["total"] > 0 and r["cost"]["flops"] > 0
    assert shard_ctx.get_mesh() is None  # the dry-run leaves no mesh behind
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_ARG_BYTES)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["memory"]["argument_bytes_per_device"] == want["bytes"]


def test_small_mesh_train_step_reports_collectives():
    cfg = reduced(get_config("qwen3-0.6b"), vocab=2048)
    tcfg = TrainConfig(global_batch=8, seq_len=64, microbatches=2, ce_chunk=0)
    with fake_group(8):
        mesh = make_host_mesh(2, 4)
        try:
            with FakeTensorMode():
                wl = make_workload(cfg, "train_4k", mesh, tcfg=tcfg)
                with implicit_replication(), RankAccounting() as acc:
                    state, metrics = wl["fn"](*wl["args"])
        finally:
            shard_ctx.set_mesh(None)
    coll = acc.collectives()
    assert coll["total"] > 0 and coll["count"] > 0
    assert coll["all-reduce"] > 0  # the row-parallel sums and the gradient norm
    assert acc.flops > 0 and acc.peak_new_bytes > 0
    assert int(state.opt.step) == 1
    assert set(metrics) == {"nll", "aux", "z", "loss", "lr"}
    assert torch.distributed.is_initialized() is False


#: (case, card, ``lm_loss`` options): the attention cores with the CE in
#: chunks and a z-loss (qwen3), the MoE's all-to-all form (kimi), the SSD
#: (mamba2), the gather MoE with d and the hidden dim split (mixtral) and
#: with the experts split (kimi-gather: 16 experts, the gather path),
#: whisper's encoder, cross-attention and its memory, internvl's patches
REAL_CASES = (
    ("qwen3-0.6b", "qwen3-0.6b", {"ce_chunk": 8, "z_loss": 1e-4}),
    ("kimi-k2-1t-a32b", "kimi-k2-1t-a32b", {}),
    ("mamba2-2.7b", "mamba2-2.7b", {}),
    ("mixtral-8x22b", "mixtral-8x22b", {}),
    ("kimi-gather", "kimi-k2-1t-a32b", {}),
    ("whisper-medium", "whisper-medium", {}),
    ("internvl2-26b", "internvl2-26b", {}),
)


def _real_cfg(case, arch):
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    if case == "kimi-k2-1t-a32b":  # per-rank capacities and aux are what the all-to-all form changes
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0,
                                                  aux_loss_weight=0.0))
    if case == "kimi-gather":  # the gather path routes as one process does: drops and aux kept
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=16, impl="gather"))
    return cfg


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    cases = []
    for i, (case, arch, opts) in enumerate(REAL_CASES):
        cfg = _real_cfg(case, arch)
        model = init_params(cfg, torch.Generator().manual_seed(i), device="cpu")
        cases.append((cfg, {k: v.numpy() for k, v in model.state_dict().items()}, opts))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 500, (4, 16))
    d = cases[0][0].d_model
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "frames": rng.standard_normal((4, 64, d)).astype(np.float32),
             "patches": rng.standard_normal((4, 16, d)).astype(np.float32)}
    rdzv = tmp_path_factory.mktemp("rdzv") / "rdzv"
    res = parties.run_parties(sharded_lm_rank, 8, (2, 4), cases, batch, backend="gloo",
                              init_method=f"file://{rdzv}", device="cpu", timeout=300)
    return cases, batch, res


@pytest.mark.parametrize("case", [c[0] for c in REAL_CASES])
def test_the_sharded_program_computes_the_one_process_numbers(sharded_runs, case):
    cases, batch, res = sharded_runs
    i = [c[0] for c in REAL_CASES].index(case)
    cfg, state, opts = cases[i]
    assert cfg.encoder_seq in (0, batch["frames"].shape[1])
    assert cfg.num_patches in (0, batch["patches"].shape[1])
    model = init_params(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    tokens, labels = (torch.from_numpy(batch[k]) for k in ("tokens", "labels"))
    kw = {}
    if cfg.encoder_layers:
        kw["frames"] = torch.from_numpy(batch["frames"])
    if cfg.num_patches:
        kw["patches"] = torch.from_numpy(batch["patches"])
    s = tokens.shape[1]
    loss, metrics = lm_loss(model, cfg, tokens, labels, **kw, **opts)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    with torch.no_grad():
        logits = model(tokens, **kw)
        cache = model.init_cache(tokens.shape[0], 2 * s + cfg.num_patches)
        prefill = model.prefill(tokens, cache, **kw)
        decode = model.decode_step(tokens[:, -1:], cache, s + cfg.num_patches)
    for r in res:  # every rank gathered the same whole results
        got = r[i]
        for name, want in (("loss", loss), ("nll", metrics["nll"])):
            np.testing.assert_allclose(got[name], want.detach().numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
        for name, want in (("logits", logits), ("prefill", prefill), ("decode", decode)):
            np.testing.assert_allclose(got[name], want.numpy(), rtol=0, atol=1e-5, err_msg=name)
        for k, g in zip(named, grads):
            want = g.numpy()
            err = np.abs(got["grads"][k] - want).max() / max(np.abs(want).max(), 1e-30)
            assert err < 1e-5, (k, err)


def test_the_kernels_as_shape_only_operators():
    """Flash and the SSD chunks are one operator each: under
    ``FakeTensorMode`` the kernel's outputs and FLOPs, no (S, T) score
    matrix, and a gradient of the right shapes; on CPU tensors the plain
    versions."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as sops

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 16, 8, generator=g) for _ in range(3))
    ssd_in = (torch.randn(1, 2, 3, 4, 8, generator=g), torch.rand(1, 2, 3, 4, generator=g),
              -torch.rand(2, generator=g), torch.randn(1, 3, 4, 5, generator=g),
              torch.randn(1, 3, 4, 5, generator=g))
    torch.testing.assert_close(torch.ops.repro_torch.flash_attention(q, k, v, True, 0),
                               attention_ref(q, k, v, causal=True, window=0))
    for got, want in zip(torch.ops.repro_torch.ssd_chunks(*ssd_in),
                         sops.ssd_chunks_plain(*ssd_in)):
        torch.testing.assert_close(got, want)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t).requires_grad_() for t in (q, k, v))
        fs = [mode.from_tensor(t).requires_grad_() for t in ssd_in]
        with RankAccounting() as acc:
            out = fops.flash_attention(fq, fk, fv, causal=True)
            y, state, decay = sops.ssd_chunks(*fs)
        assert out.shape == q.shape and acc.peak_new_bytes == sum(
            t.numel() * 4 for t in (out, y, state, decay))
        b, h, s, dh = q.shape
        b2, h2, nc, qq, p = ssd_in[0].shape
        n = ssd_in[3].shape[-1]
        assert acc.flops == 4 * b * h * s * s * dh + (
            2 * b2 * nc * qq * qq * n + 2 * b2 * h2 * nc * qq * qq * p + 2 * b2 * h2 * nc * qq * p * n)
        grads = torch.autograd.grad((out.sum(), y.sum(), state.sum()), [fq, fk, fv, *fs])
        assert [t.shape for t in grads] == [t.shape for t in (q, k, v, *ssd_in)]
