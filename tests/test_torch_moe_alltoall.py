"""The port's expert-parallel MoE (``repro_torch.models.moe.apply_moe_alltoall``)
against the JAX package's shard_map ``apply_moe_alltoall``.

The reference runs once per module in a subprocess with eight forced host
devices on a (4, 2) ('data', 'model') mesh, as
``tests/test_dryrun_and_distributed.py`` runs it, on kimi-k2 reduced and
widened to 16 experts (4 on each data rank, top-2, a shared expert) in
fp32, at capacity factors 16 and 1.25 (no drops at this size) and 0.5
(drops at both stages), with route groups 0 (the plain branch) and 3
(node-limited routing, the grouped branch). It writes its inputs, outputs, the gradients
of ``sum(y²) + aux``, the all-to-all bytes of the compiled forward
(``utils.hlo.collective_bytes``) and each data rank's drops at both stages,
counted with its own ``_dispatch_positions`` on its own routing.

The port runs on 8 spawned ``gloo`` ranks on the CPU (``tests/_torch_ranks.py``),
each holding its shards. The ranks' gradients of a replicated tensor
(router, shared experts) are shares that add up to the whole; a sharded
tensor's are its block's.

Tolerances: outputs within 1e-5, aux within 1e-6, gradients within 1e-5 of
the largest entry; drops and all-to-all bytes equal.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import moe_rank
from repro_torch.configs import get_config, reduced
from repro_torch.core import parties

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = (4, 2)
NUM_EXPERTS = 16  # 4 local experts a data rank: the local-expert ids and slots vary
CASES = [(0, 16.0), (0, 1.25), (3, 16.0), (3, 1.25), (0, 0.5), (3, 0.5)]
IDS = [f"groups{g}-cf{cf}" for g, cf in CASES]

REFERENCE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.moe import _dispatch_positions, apply_moe_alltoall, init_moe
from repro.sharding import context as shard_ctx
from repro.sharding.context import auto_axis_types_kw
from repro.utils.hlo import collective_bytes

CASES = {cases}
DSIZE, MSIZE = {mesh}
NUM_EXPERTS = {experts}
mesh = jax.make_mesh((DSIZE, MSIZE), ("data", "model"), **auto_axis_types_kw(2))
shard_ctx.set_mesh(mesh)
base = reduced(get_config("kimi-k2-1t-a32b")).replace(dtype="float32")
base = base.replace(moe=dataclasses.replace(base.moe, num_experts=NUM_EXPERTS))
p = init_moe(jax.random.PRNGKey(0), base, base.d_model)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, base.d_model))
out = {{"x": np.asarray(x)}}
for k, v in p.items():
    out[f"p/{{k}}"] = np.asarray(v)


def drops(cfg):
    # each data rank's routing, as the reference's local_fn routes, then its
    # _dispatch_positions at stage 1 and on what each rank receives
    m = cfg.moe
    e_local, k = m.num_experts // DSIZE, m.experts_per_token
    groups = m.route_groups if 0 < m.route_groups < DSIZE else 0
    sends, d1 = [], []
    for r in range(DSIZE):
        xf = x[r * 8 // DSIZE:(r + 1) * 8 // DSIZE].reshape(-1, cfg.d_model)
        tl = xf.shape[0]
        probs = jax.nn.softmax(xf @ p["router"], axis=-1)
        if groups:
            _, gsel = jax.lax.top_k(jnp.max(probs.reshape(tl, DSIZE, e_local), -1), groups)
            allowed = jnp.zeros((tl, DSIZE), bool).at[jnp.arange(tl)[:, None], gsel].set(True)
            probs = jnp.where(jnp.repeat(allowed, e_local, axis=1), probs, 0.0)
        gate, idx = jax.lax.top_k(probs, k)
        if groups:
            gmat = jnp.zeros((tl, m.num_experts)).at[jnp.arange(tl)[:, None], idx].set(gate)
            gm = jnp.take_along_axis(gmat.reshape(tl, DSIZE, e_local), gsel[..., None],
                                     axis=1).reshape(tl * groups, e_local)
            ids1, item = gsel.reshape(-1), gm
            cap1 = max(8, -(-int(tl * groups / DSIZE * m.capacity_factor) // 8) * 8)
        else:
            flat = idx.reshape(-1)
            ids1, item = flat // e_local, (flat % e_local)[:, None]
            cap1 = max(8, -(-int(tl * k / DSIZE * m.capacity_factor) // 8) * 8)
        keep1, dest1 = _dispatch_positions(ids1, DSIZE, cap1)
        slots = np.full((DSIZE * cap1 + 1, item.shape[1]), -1.0)
        slots[np.asarray(dest1)] = np.where(np.asarray(keep1)[:, None], np.asarray(item), -1.0)
        sends.append(slots[:-1].reshape(DSIZE, cap1, -1))
        d1.append(int((~keep1).sum()))
    d2 = []
    for r in range(DSIZE):
        recv = np.concatenate([s[r] for s in sends])              # (T2, ·)
        t2 = recv.shape[0]
        if groups:
            ids2 = np.where(recv > 0, np.arange(e_local)[None, :], -1).reshape(-1)
            cap2 = max(8, -(-int(t2 * min(k, e_local) / (groups * e_local)
                                 * m.capacity_factor) // 8) * 8)
        else:
            ids2 = recv[:, 0].astype(np.int32)
            cap2 = max(8, -(-int(t2 / e_local * m.capacity_factor) // 8) * 8)
        keep2, _ = _dispatch_positions(jnp.asarray(ids2), e_local, cap2)
        d2.append(int((ids2 >= 0).sum()) - int(keep2.sum()))
    return d1, d2


for i, (groups, cf) in enumerate(CASES):
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf,
                                               route_groups=groups))
    f = jax.jit(lambda p, x: apply_moe_alltoall(p, x, cfg, mesh))
    with mesh:
        y, aux = f(p, x)
        g = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[0] ** 2) + f(p, x)[1]))(p, x)
        a2a = collective_bytes(f.lower(p, x).compile().as_text()).get("all-to-all", 0)
    out[f"{{i}}/y"], out[f"{{i}}/aux"] = np.asarray(y), np.asarray(aux)
    for k, v in g.items():
        out[f"{{i}}/g/{{k}}"] = np.asarray(v)
    out[f"{{i}}/a2a"] = np.asarray(a2a)
    d1, d2 = drops(cfg)
    out[f"{{i}}/drops1"], out[f"{{i}}/drops2"] = np.asarray(d1), np.asarray(d2)
np.savez(sys.argv[1], **out)
""".format(cases=CASES, mesh=MESH, experts=NUM_EXPERTS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_a2a") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return np.load(path)


def _cfg(groups, cf):
    import dataclasses

    base = reduced(get_config("kimi-k2-1t-a32b")).replace(dtype="float32")
    return base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf,
                                                route_groups=groups, num_experts=NUM_EXPERTS))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The port's 8 ranks, each case in turn: case → the ranks' results."""
    params = {k[2:]: reference[k] for k in reference.files if k.startswith("p/")}
    cfgs = [_cfg(groups, cf) for groups, cf in CASES]
    rdzv = tmp_path_factory.mktemp("rdzv") / "rdzv"
    res = parties.run_parties(moe_rank, 8, MESH, cfgs, params, reference["x"], backend="gloo",
                              init_method=f"file://{rdzv}", device="cpu", timeout=120)
    return {i: [r[i] for r in res] for i in range(len(CASES))}


def _whole(name, results):
    """A tensor's gradient from the ranks': the sum of the shares of a
    replicated one, the blocks of a sharded one put together."""
    data, model = MESH
    g = {tuple(r["coord"]): r["grads"][name] for r in results}
    if name == "router":
        return sum(g.values())
    if name.startswith("shared"):
        axis = 2 if name != "shared_down" else 1
        return np.concatenate([sum(g[(dr, mr)] for dr in range(data)) for mr in range(model)],
                              axis=axis)
    axis = 2 if name != "w_down" else 1
    rows = [np.concatenate([g[(dr, mr)] for mr in range(model)], axis=axis)
            for dr in range(data)]
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_outputs_and_aux_match_the_reference(reference, ranks, case):
    res = ranks[case]
    data, model = MESH
    y = np.concatenate([next(r["y"] for r in res if r["coord"] == [dr, 0])
                        for dr in range(data)])
    np.testing.assert_allclose(y, reference[f"{case}/y"], rtol=0, atol=1e-5)
    for r in res:  # the model ranks of a data rank hold the same rows
        dr = r["coord"][0]
        np.testing.assert_array_equal(r["y"], y[dr * 2:(dr + 1) * 2])
        np.testing.assert_allclose(r["aux"], reference[f"{case}/aux"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_gradients_match_the_reference(reference, ranks, case):
    for name in ("w_gate", "w_up", "w_down", "router", "shared_gate", "shared_up",
                 "shared_down"):
        want = reference[f"{case}/g/{name}"]
        got = _whole(name, ranks[case])
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-5, (name, err)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_drops_and_all_to_all_bytes_match_the_reference(reference, ranks, case):
    res = sorted(ranks[case], key=lambda r: r["coord"])
    d1 = [r["stats"]["dropped1"] for r in res if r["coord"][1] == 0]
    d2 = [r["stats"]["dropped2"] for r in res if r["coord"][1] == 0]
    assert d1 == list(reference[f"{case}/drops1"])
    assert d2 == list(reference[f"{case}/drops2"])
    if CASES[case][1] == 16.0:
        assert sum(d1) == sum(d2) == 0
    if CASES[case][1] < 1:
        assert min(d1) > 0 and sum(d2) > 0
    for r in res:
        assert r["collectives"]["all-to-all"] == int(reference[f"{case}/a2a"])
        # the forward hands gloo (data-1)/data of each exchange's buffer and
        # the model reduction's (T, d) outputs
        sent = r["collectives"]["all-to-all"] * (MESH[0] - 1) // MESH[0]
        assert r["traffic"]["bytes"] == sent + r["y"].size * 4


@pytest.mark.parametrize("case", [i for i, (g, cf) in enumerate(CASES) if cf == 16.0],
                         ids=[IDS[i] for i, (g, cf) in enumerate(CASES) if cf == 16.0])
def test_no_drop_alltoall_equals_the_one_process_gather_path(reference, ranks, case):
    """Where nothing drops, the ranks' outputs are the one-process gather
    path's over the same routing (``MoE.node_limited``; with route groups
    0 every group is allowed) — the check the card runs at kimi's width."""
    import torch

    from repro_torch.models.moe import MoE

    groups, _ = CASES[case]
    cfg = _cfg(groups or MESH[0], 16.0)
    moe = MoE(cfg)
    moe.load_state_dict({k[2:]: torch.from_numpy(reference[k]) for k in reference.files
                         if k.startswith("p/")})
    x = torch.from_numpy(reference["x"])
    with torch.no_grad():
        y, keep = moe.node_limited(x, MESH[0], x.shape[0] * x.shape[1])
    assert bool(keep.all())
    got = np.concatenate([next(r["y"] for r in ranks[case] if r["coord"] == [dr, 0])
                          for dr in range(MESH[0])])
    np.testing.assert_allclose(got, y.numpy(), rtol=0, atol=1e-5)
