"""The port's two-party topology (``repro_torch.core.parties``) against the
JAX package's party mesh (``repro.core.distributed``).

The port's ranks are spawned ``gloo`` processes on the CPU
(``run_parties``, a ``file://`` rendezvous under the test's temporary
directory). The reference runs once per module in a subprocess with eight
forced host devices, as ``tests/test_dryrun_and_distributed.py`` runs it,
and writes its inputs and results to an ``.npz``; inputs come from numpy
seeds and the reference's own keys.

Tolerances: exchange states and metrics within 1e-5 over 10 rounds, vote
counts equal; sharded tables within 1e-5 after 20 steps and losses within
1e-6; the two-process exchange bit-equal to the in-process stepwise
handshake on the same draws (one intra-op thread on both sides).
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401
from repro_torch.core import parties
from repro_torch.core.pate import laplace_noise
from repro_torch.core.ppat import PPATClient, PPATConfig, PPATHost, host_params_from_numpy
from repro_torch.core.privacy import MomentsAccountant
from repro_torch.kge.models import KGEModel

REPO = pathlib.Path(__file__).resolve().parents[1]
D, N, B, ROUNDS = 16, 100, 32, 10          # the exchange's size
KGE_DIM, KGE_STEPS, KGE_BATCH, KGE_LR = 32, 20, 128, 0.3
FAMILIES = ("transe", "distmult")

REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.distributed import (init_distributed_ppat, make_party_mesh,
                                    make_sharded_kge_step, ppat_exchange_step)
from repro.core.ppat import PPATConfig
from repro.kge.data import corrupt_triples, synthesize_universe
from repro.kge.models import KGEModel, init_kge
from repro.sharding.context import auto_axis_types_kw

D, N, B, ROUNDS = {D}, {N}, {B}, {ROUNDS}
out = {{}}

def put(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            put(f"{{prefix}}/{{k}}", v)
        else:
            out[f"{{prefix}}/{{k}}"] = np.asarray(v)

key = jax.random.PRNGKey(0)
x = np.asarray(jax.random.normal(key, (N, D)))
y = x @ np.asarray(jnp.linalg.qr(jax.random.normal(jax.random.PRNGKey(1), (D, D)))[0])
mesh = make_party_mesh(2)
zeros = np.zeros((B, D), np.float32)
for sat in (0, 1):
    cfg = PPATConfig(saturating=bool(sat))
    state = init_distributed_ppat(key, D, cfg)
    put(f"ppat{{sat}}/init", state)
    step = ppat_exchange_step(mesh, cfg)
    rng = np.random.default_rng(0)
    xbs, ybs, noise, mets, n0s, n1s = [], [], [], [], [], []
    for i in range(ROUNDS):
        xb, yb = x[rng.integers(0, N, B)], y[rng.integers(0, N, B)]
        keys = jax.random.split(jax.random.fold_in(key, i), 2)
        state, m, (n0, n1) = step(state, jnp.stack([xb, zeros]), jnp.stack([zeros, yb]), keys)
        xbs.append(xb); ybs.append(yb)
        noise.append(np.asarray(jax.random.laplace(keys[1], (2, B))))
        mets.append([float(m[k][1]) for k in ("gen_loss", "student_loss", "teacher_loss")])
        n0s.append(np.asarray(n0)[B:]); n1s.append(np.asarray(n1)[B:])
    put(f"ppat{{sat}}/final", state)
    for k, v in (("xbs", xbs), ("ybs", ybs), ("noise", noise), ("metrics", mets),
                 ("n0", n0s), ("n1", n1s)):
        out[f"ppat{{sat}}/{{k}}"] = np.asarray(v)

kgs = synthesize_universe(seed=0, scale=1 / 400,
                          kg_stats=[("A", 10, 90000, 300000), ("B", 8, 70000, 240000)],
                          alignments=[("A", "B", 30000)])
a = kgs["A"]
e_pad = -(-a.num_entities // 8) * 8
mesh_kge = jax.make_mesh((2, 4), ("data", "model"), **auto_axis_types_kw(2))
for family in ("transe", "distmult"):
    model = KGEModel(family, e_pad, a.num_relations, {KGE_DIM}, margin=2.0)
    p = init_kge(jax.random.PRNGKey(7), model)
    put(f"{{family}}/init", p)
    step = make_sharded_kge_step(mesh_kge, model, lr={KGE_LR})
    rng = np.random.default_rng(0)
    pos, neg, losses = [], [], []
    for _ in range({KGE_STEPS}):
        batch = a.train[rng.integers(0, len(a.train), {KGE_BATCH})]
        ng = corrupt_triples(rng, batch, a.num_entities)
        p, loss = step(p, jnp.asarray(batch), jnp.asarray(ng))
        pos.append(batch); neg.append(ng); losses.append(float(loss))
    put(f"{{family}}/final", p)
    out[f"{{family}}/pos"], out[f"{{family}}/neg"] = np.asarray(pos), np.asarray(neg)
    out[f"{{family}}/losses"] = np.asarray(losses)
    out[f"{{family}}/shape"] = np.asarray([e_pad, a.num_relations])
np.savez(sys.argv[1], **out)
""".format(D=D, N=N, B=B, ROUNDS=ROUNDS, KGE_DIM=KGE_DIM, KGE_STEPS=KGE_STEPS,
           KGE_BATCH=KGE_BATCH, KGE_LR=KGE_LR)


def _tree(ref, prefix):
    """The nested dict saved under ``prefix/...``."""
    out = {}
    for name in ref.files:
        if name.startswith(prefix + "/"):
            node = out
            *path, leaf = name[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[name]
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), str(path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return np.load(path)


class Rendezvous:
    """A fresh ``file://`` rendezvous for each run of the parties."""

    def __init__(self, root):
        self.root, self.n = root, 0

    def __call__(self):
        self.n += 1
        return f"file://{self.root / f'rdzv{self.n}'}"


@pytest.fixture(scope="module")
def rdzv(tmp_path_factory):
    return Rendezvous(tmp_path_factory.mktemp("rdzv"))


def _run(fn, world, *args, rdzv):
    return parties.run_parties(fn, world, *args, backend="gloo", init_method=rdzv(),
                               device="cpu", timeout=120)


@pytest.fixture(scope="module")
def exchanges(reference, rdzv, one_torch_thread):  # noqa: F811
    """The port's exchange over the reference's 10 rounds, both generator
    losses: (client result, host result) for ``saturating`` 0 and 1."""
    out = {}
    for sat in (0, 1):
        cfg = PPATConfig(saturating=bool(sat))
        init = _tree(reference, f"ppat{sat}/init")
        out[sat] = _run(parties.exchange_party, 2, cfg, init, reference[f"ppat{sat}/xbs"],
                        reference[f"ppat{sat}/ybs"], reference[f"ppat{sat}/noise"], rdzv=rdzv)
    return out


@pytest.mark.parametrize("sat", [0, 1], ids=["non-saturating", "saturating"])
def test_exchange_matches_the_reference(reference, exchanges, sat):
    client, host = exchanges[sat]
    want = _tree(reference, f"ppat{sat}/final")
    for k in parties.CLIENT_KEYS:
        np.testing.assert_allclose(client["state"][k], want[k], rtol=0, atol=1e-5, err_msg=k)
    for k in parties.HOST_KEYS:
        for leaf, v in want[k].items():
            np.testing.assert_allclose(host["state"][k][leaf], v, rtol=0, atol=1e-5,
                                       err_msg=f"{k}.{leaf}")
    assert set(client["state"]) == set(parties.CLIENT_KEYS)
    assert set(host["state"]) == set(parties.HOST_KEYS)
    hist = host["history"]
    np.testing.assert_array_equal(hist["n0"], reference[f"ppat{sat}/n0"])
    np.testing.assert_array_equal(hist["n1"], reference[f"ppat{sat}/n1"])
    got = np.stack([hist[k] for k in ("gen_loss", "student_loss", "teacher_loss")], axis=1)
    np.testing.assert_allclose(got, reference[f"ppat{sat}/metrics"], rtol=0, atol=1e-5)
    assert client["history"] == {}


@pytest.mark.parametrize("sat", [0, 1], ids=["non-saturating", "saturating"])
def test_the_pipe_carries_two_tensors_a_round(exchanges, sat):
    """Each round the client sends one (B, d) fp32 tensor and the host one
    back; nothing else leaves either process."""
    for result in exchanges[sat]:
        t = result["traffic"]
        assert t["shapes"] == {f"float32[{B}, {D}]": ROUNDS}
        assert t["tensors"] == ROUNDS and t["bytes"] == ROUNDS * B * D * 4
    total = sum(r["traffic"]["bytes"] for r in exchanges[sat])
    assert total == ROUNDS * 2 * B * D * 4


def test_exchange_equals_the_in_process_handshake(rdzv, one_torch_thread):  # noqa: F811
    """The same draws two ways: two processes through the pipe, and one
    process through ``PPATClient`` and ``PPATHost.step``: bit-equal."""
    cfg = PPATConfig(steps=12, seed=3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = (x @ np.linalg.qr(rng.standard_normal((D, D)))[0]).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    init = parties.init_distributed_ppat(gen, D, cfg)
    noise = laplace_noise(gen, (cfg.steps, 2, cfg.batch))
    # the batches the in-process parties draw from their numpy streams
    xi, yi = np.random.default_rng(cfg.seed + 29), np.random.default_rng(cfg.seed + 17)
    xbs = np.stack([x[xi.integers(0, N, cfg.batch)] for _ in range(cfg.steps)])
    ybs = np.stack([y[yi.integers(0, N, cfg.batch)] for _ in range(cfg.steps)])
    client, host = _run(parties.exchange_party, 2, cfg, init, xbs, ybs, noise, rdzv=rdzv)

    ppat_client = PPATClient(D, torch.from_numpy(x), cfg)
    ppat_host = PPATHost(None, D, torch.from_numpy(y), cfg,
                         params=host_params_from_numpy(
                             {k: {n: v.numpy() for n, v in init[k].items()}
                              for k in parties.HOST_KEYS}, "cpu"))
    votes = []
    update = ppat_host.accountant.update
    ppat_host.accountant.update = lambda n0, n1: (votes.append((n0, n1)), update(n0, n1))
    for s in range(cfg.steps):
        xb, adv = ppat_client.sample_batch()
        grad, _ = ppat_host.step(adv, noise[s])
        ppat_client.apply_grad(xb, grad)
    assert np.array_equal(client["state"]["w"], ppat_client.w.numpy())
    assert np.array_equal(client["state"]["w_vel"], ppat_client.vel.numpy())
    for k in parties.HOST_KEYS:
        for leaf, v in ppat_host.params[k].items():
            assert np.array_equal(host["state"][k][leaf], v.numpy()), (k, leaf)
    assert np.array_equal(host["history"]["n0"], np.stack([v[0] for v in votes]))
    assert np.array_equal(host["history"]["n1"], np.stack([v[1] for v in votes]))
    acct = MomentsAccountant(cfg.lam, cfg.delta)
    for n0, n1 in zip(host["history"]["n0"], host["history"]["n1"]):
        acct.update(n0, n1)
    assert acct.epsilon() == ppat_host.accountant.epsilon()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_step_matches_the_reference(reference, rdzv, one_torch_thread,  # noqa: F811
                                            family, world):
    """World 2 and 4 against the reference's (2, 4) mesh (batch over
    ``data``, rows over ``model``): the example's universe at scale 1/400,
    d = 32, 20 steps."""
    e, r = (int(v) for v in reference[f"{family}/shape"])
    model = KGEModel(family, e, r, KGE_DIM, margin=2.0)
    res = _run(parties.sharded_party, world, model, KGE_LR, _tree(reference, f"{family}/init"),
               reference[f"{family}/pos"], reference[f"{family}/neg"], rdzv=rdzv)
    want = _tree(reference, f"{family}/final")
    got = res[0]["params"]
    for k in ("ent", "rel"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    for rank in range(world):
        np.testing.assert_allclose(res[rank]["losses"], reference[f"{family}/losses"],
                                   rtol=0, atol=1e-6)
        assert res[rank]["shard_bytes"] == (e // world + r) * KGE_DIM * 4
    assert all(x["params"] is None for x in res[1:])


def test_sharded_bytes_do_not_grow_with_the_table(rdzv, one_torch_thread):  # noqa: F811
    """The bytes a step moves depend on the batch and the width, not on the
    entity table: tables of 64 and 4,096 rows move the same per step."""
    rng = np.random.default_rng(0)
    b, d, r, steps, world = 16, 8, 5, 3, 2
    moved = []
    for e in (64, 4096):
        params = {"ent": rng.standard_normal((e, d)).astype(np.float32),
                  "rel": rng.standard_normal((r, d)).astype(np.float32)}
        pos = np.stack([rng.integers(0, [e, r, e], (b, 3)) for _ in range(steps)])
        neg = np.stack([rng.integers(0, [e, r, e], (b, 3)) for _ in range(steps)])
        res = _run(parties.sharded_party, world, KGEModel("transe", e, r, d), 0.1, params,
                   pos, neg, rdzv=rdzv)
        moved.append([x["traffic"]["bytes"] for x in res])
    # per rank and step: rows out and gradients back (4·B/W slots to the
    # other rank), the relation slots' gradients, the loss
    per_step = 2 * (world - 1) * 4 * (b // world) * d * 4 + 2 * (b // world) * d * 4 + 4
    assert moved[0] == moved[1] == [steps * per_step] * world


def _group(world=2, rank=0):
    """A group of ``world`` that is never joined: enough for the checks a
    step makes before it communicates."""
    return parties.PartyGroup(rank, world, torch.device("cpu"), "gloo")


def test_sharded_step_rejects_what_it_cannot_split():
    m = KGEModel("transe", 10, 3, 4)
    with pytest.raises(ValueError, match="10 rows do not split over 4 ranks"):
        parties.make_sharded_kge_step(_group(4), m, lr=0.1)
    with pytest.raises(ValueError, match="transh"):
        parties.make_sharded_kge_step(_group(), KGEModel("transh", 10, 3, 4), lr=0.1)
    with pytest.raises(ValueError, match="exactly ent and rel"):
        parties.shard_params({"ent": np.zeros((10, 4)), "rel": np.zeros((3, 4)),
                              "norm_vec": np.zeros((3, 4))}, _group())
    step = parties.make_sharded_kge_step(_group(), m, lr=0.1)
    shard = parties.shard_params({"ent": np.zeros((10, 4)), "rel": np.zeros((3, 4))}, _group())
    with pytest.raises(ValueError, match="batch of 3 triples does not split over 2"):
        step(shard, np.zeros((3, 3), np.int64), np.zeros((3, 3), np.int64))


@pytest.mark.parametrize("kw,err,match", [
    (dict(backend="mpi", device="cpu"), ValueError, "unknown backend"),
    (dict(backend="nccl", device="cpu"), RuntimeError, "nccl needs one card per rank"),
    (dict(backend="gloo", device="cpu"), ValueError, "needs an init_method"),
])
def test_party_group_rules(kw, err, match):
    with pytest.raises(err, match=match):
        parties.make_party_group(0, 2, **kw)


def test_a_failing_rank_fails_the_run(rdzv):
    """The host raises (no vote noise) while the client waits on the pipe:
    the run fails at once, naming the host's rank and its error."""
    cfg = PPATConfig(batch=4, hidden=4)
    init = parties.init_distributed_ppat(torch.Generator().manual_seed(0), 2, cfg)
    xbs = np.zeros((1, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match=r"party rank 1 of 2 failed:(.|\n)*Laplace draws"):
        _run(parties.exchange_party, 2, cfg, init, xbs, xbs, None, rdzv=rdzv)


def test_the_example_runs_on_the_cpu():
    """``examples/distributed_fkge_torch.py`` end to end on the CPU, cut to
    a few steps and rounds."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, str(REPO / "examples" / "distributed_fkge_torch.py"),
                        "--device", "cpu", "--kge-steps", "4", "--rounds", "3"],
                       capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    out = r.stdout
    assert "backend gloo" in out and "sharded KGE 4 steps" in out
    assert f"pipe: 2 tensors, {2 * 32 * 32 * 4} bytes a round" in out
    assert "CSLS retrieval" in out
