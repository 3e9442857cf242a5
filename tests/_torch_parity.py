"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: seeded inputs made with numpy, dyadic tables on which fp32 sums
are exact in any order, and the near-tie rule for rank counts."""
import jax
import numpy as np
import pytest
import torch

from repro.kge.models import KGEModel as JaxKGEModel
from repro.kge.models import init_kge as jax_init_kge


def dyadic(rng: np.random.Generator, shape) -> np.ndarray:
    """Entries k/64 with |k| <= 64: with d <= 32 (d <= 16 for ComplEx's
    2d-wide table) every product and sum the scores take is exact in fp32,
    so the two frameworks agree bit for bit whatever their summation order."""
    return (rng.integers(-64, 65, shape) / 64.0).astype(np.float32)


def jax_params(family: str, e: int, r: int, d: int, *, seed: int = 0,
               norm_ord: int = 1, dyadic_tables: bool = True):
    """(model, numpy params) from the JAX package's ``init_kge``; with
    ``dyadic_tables`` every table except RotatE's phases is rounded to the
    dyadic grid."""
    m = JaxKGEModel(family, e, r, d, norm_ord=norm_ord)
    p = {k: np.asarray(v) for k, v in jax_init_kge(jax.random.PRNGKey(seed), m).items()}
    if dyadic_tables:
        for k, v in p.items():
            if family == "rotate" and k == "rel":
                continue
            p[k] = np.clip(np.round(v * 64.0) / 64.0, -1.0, 1.0).astype(np.float32)
    return m, p


def near_tie_ok(a: np.ndarray, b: np.ndarray, scores: np.ndarray,
                gold: np.ndarray) -> bool:
    """Rank counts may differ per query by at most the number of entities
    whose score lies within 1e-5·(1+|gold|) of gold."""
    near = (np.abs(scores - gold[:, None]) <= 1e-5 * (1 + np.abs(gold[:, None]))).sum(1)
    return bool((np.abs(a.astype(np.int64) - b.astype(np.int64)) <= near).all())


def triples(rng: np.random.Generator, n: int, e: int, r: int) -> np.ndarray:
    return np.stack(
        [rng.integers(0, e, n), rng.integers(0, r, n), rng.integers(0, e, n)], axis=1
    ).astype(np.int64)


def jax_draws(key, epochs: int, n_pad: int, nb: int, batch: int, num_entities: int):
    """Each epoch's (perm, corrupt_head, rand_ent) exactly as the JAX
    package's ``kge.engine.train_scan_graph`` draws them from ``key`` inside
    its scan — the draws the port's ``train_scan_graph`` takes as input."""
    import jax.numpy as jnp

    out = []
    for ekey in jax.random.split(key, epochs):
        kp, kc, ks = jax.random.split(ekey, 3)
        out.append((
            np.asarray(jax.random.permutation(kp, n_pad)),
            np.asarray(jax.random.bernoulli(kc, 0.5, (nb, batch))),
            np.asarray(jax.random.randint(ks, (nb, batch), 0, jnp.int32(num_entities),
                                          dtype=jnp.int32)),
        ))
    return out



def jax_ppat_init(key, dim: int, cfg):
    """The discriminators a fused JAX handshake on ``key`` starts from
    (``_init_host_params(split(key)[0], ...)``), every leaf as numpy: what
    the port's ``host_params_from_numpy`` carries across."""
    from repro.core.ppat import _init_host_params

    kh, _ = jax.random.split(key)
    return jax.tree.map(np.asarray, _init_host_params(kh, dim, cfg))


def jax_ppat_draws(key, cfg, n_x: int, n_y: int):
    """A fused handshake's per-round draws exactly as the JAX package's
    ``core.ppat.ppat_entry_graph`` takes them from ``key``: (idx (steps, B),
    ridx (steps, B), noise (steps, 2, B)) as numpy. The rounds come from
    ``split(key)[1]``, split once per round, each round into (client batch
    ids, host batch ids, vote noise)."""
    import jax.numpy as jnp

    _, sub = jax.random.split(key)
    idx, ridx, noise = [], [], []
    for k in jax.random.split(sub, cfg.steps):
        kx, ky, ks = jax.random.split(k, 3)
        idx.append(np.array(jax.random.randint(kx, (cfg.batch,), 0, jnp.int32(n_x))))
        ridx.append(np.array(jax.random.randint(ky, (cfg.batch,), 0, jnp.int32(n_y))))
        noise.append(np.array(jax.random.laplace(ks, (2, cfg.batch))))
    return np.stack(idx), np.stack(ridx), np.stack(noise)


def jax_stepwise_noise(key, cfg):
    """The vote noise (steps, 2, B) of the JAX package's stepwise
    ``train_ppat(fused=False)`` on ``key``: one ``split`` per round."""
    out = []
    for _ in range(cfg.steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.laplace(sub, (2, cfg.batch))))
    return np.stack(out)


class JaxSchedulerDraws:
    """A draw source for the port's ``FederationScheduler(draws=...)`` that
    replays the JAX scheduler's streams: the PPAT key ``PRNGKey(seed + 101)``
    split once per handshake (``ppat``), and each owner's engine key
    ``PRNGKey(seed + i + 7919)`` split once per ``train_epochs`` (``train``),
    owners numbered in the order of ``names``."""

    def __init__(self, names, seed: int, cfg, dim: int):
        self.cfg, self.dim = cfg, dim
        self._key = jax.random.PRNGKey(seed + 101)
        self._engine = {n: jax.random.PRNGKey(seed + i + 7919) for i, n in enumerate(names)}

    def state_dict(self):
        """Both key streams as uint32 arrays, for the port's checkpoints."""
        return {"key": np.asarray(self._key, np.uint32),
                "engine": {n: np.asarray(k, np.uint32) for n, k in self._engine.items()}}

    def load_state_dict(self, state):
        import jax.numpy as jnp

        self._key = jnp.asarray(np.asarray(state["key"]), jnp.uint32)
        self._engine = {n: jnp.asarray(np.asarray(k), jnp.uint32)
                        for n, k in state["engine"].items()}

    def ppat(self, host, client, n_x: int, n_y: int):
        """Called once per handshake that draws, in the order the JAX
        scheduler splits its PPAT key: at run time in a barrier tick, in
        plan order when a streamed pass (or its re-offer level) is planned."""
        import torch

        from repro_torch.core.ppat import PPATDraws, host_params_from_numpy

        self._key, key = jax.random.split(self._key)
        init = host_params_from_numpy(jax_ppat_init(key, self.dim, self.cfg), "cpu")
        draws = jax_ppat_draws(key, self.cfg, n_x, n_y)
        return init, PPATDraws(*(torch.as_tensor(a) for a in draws))

    def train(self, owner, epochs: int, n_pad: int, nb: int, batch: int, num_entities: int):
        self._engine[owner], sub = jax.random.split(self._engine[owner])
        return jax_draws(sub, epochs, n_pad, nb, batch, num_entities)


# ------------------------------------------------ scheduler-level parity
#: the universe of ``tests/test_federation.py`` and ``tests/test_adversary.py``
STATS = [("A", 12, 90000, 300000), ("B", 10, 70000, 240000), ("C", 8, 60000, 200000)]
ALIGNS = [("A", "B", 30000), ("B", "C", 20000), ("A", "C", 18000)]
EVENT_FIELDS = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
                "owner_clock", "view_version")
#: the port's two tick engines, each held against the JAX serial scheduler
ENGINES = ("reference", "batched")


def make_universes(seed=1, stats=STATS, aligns=ALIGNS, scale=1 / 500):
    """(JAX universe, port universe) from the same seed, at scale 1/500 by
    default; ``stats=None`` and ``aligns=None`` give the eleven KGs of
    Tab. 2 and the alignments of Tab. 3."""
    from repro.kge.data import synthesize_universe as jax_universe
    from repro_torch.kge.data import synthesize_universe

    return (jax_universe(seed=seed, scale=scale, kg_stats=stats, alignments=aligns),
            synthesize_universe(seed=seed, scale=scale, kg_stats=stats, alignments=aligns))


def _pair(universes, *, dim=16, steps=12, faults=None, engine="reference", families=None,
          **kw):
    """(JAX scheduler, port scheduler) on the same tables and draws: the JAX
    one with its serial engine, the port's with ``engine`` (its
    ``tick_impl``) from ``JaxSchedulerDraws``.
    ``families`` maps owners to KGE families (TransE for all by default).
    ``faults`` is ``(FaultPlan kwargs, table {(tick, host): Fault kwargs})``
    and builds one injector for each; every other keyword (an adversary
    spec, the defenses, ...) goes to both."""
    from repro.core.faults import Fault as JFault
    from repro.core.faults import FaultInjector as JInjector
    from repro.core.faults import FaultPlan as JPlan
    from repro.core.federation import FederationScheduler as JaxScheduler
    from repro.core.ppat import PPATConfig as JaxPPATConfig
    from repro_torch.core import faults as tf
    from repro_torch.core.federation import FederationScheduler
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.models import params_from_numpy

    jkgs, tkgs = universes
    kw = {"local_epochs": 2, "update_epochs": 1, "seed": 0, **kw}
    if families is not None:
        kw["families"] = families
    jcfg = JaxPPATConfig(steps=steps, seed=0)
    jkw, tkw = dict(kw), dict(kw)
    if faults is not None:
        plan, table = faults
        jkw["tick_faults"] = JInjector(JPlan(**plan, table={
            k: JFault(**v) for k, v in table.items()} if table else None))
        tkw["tick_faults"] = tf.FaultInjector(tf.FaultPlan(**plan, table={
            k: tf.Fault(**v) for k, v in table.items()} if table else None))
    j = JaxScheduler(jkgs, dim=dim, ppat_cfg=jcfg, tick_impl="reference", **jkw)
    t = FederationScheduler(tkgs, dim=dim, ppat_cfg=PPATConfig(steps=steps, seed=0),
                            device="cpu", draws=JaxSchedulerDraws(list(tkgs), 0, jcfg, dim),
                            tick_impl=engine, **tkw)
    for n, tr in t.trainers.items():
        tr.params = params_from_numpy(
            {k: np.asarray(v) for k, v in j.trainers[n].params.items()}, "cpu")
    return j, t


def _score_tol(t, name):
    """One scoring triple: 1/|valid| for accuracy, 1/(2·n) for Hit@10."""
    n = len(t.kgs[name].valid)
    return 1 / (2 * min(n, t.score_max_test)) if t.score_metric == "hit10" else 1 / n


def assert_same_events(j_events, t_events, t):
    """Events equal field for field (``EVENT_FIELDS``), ε bit for bit, the
    scores within one scoring triple."""
    assert len(j_events) == len(t_events)
    for a, b in zip(j_events, t_events):
        assert [getattr(b, f) for f in EVENT_FIELDS] == [getattr(a, f) for f in EVENT_FIELDS]
        assert repr(b.epsilon) == repr(a.epsilon)  # bit-equal, NaN for non-handshakes
        for f in ("score_before", "score_after"):
            assert abs(getattr(b, f) - getattr(a, f)) <= _score_tol(t, b.host), (f, a, b)


def assert_same(j, t):
    """The events, ε, queues, states, failure ledgers and reputation
    exactly (ε bit for bit), the scores within one scoring triple and the
    tables within atol 1e-5, for the whole history so far."""
    assert_same_events(j.events, t.events, t)
    assert t.epsilons == j.epsilons
    assert t.accountant.epsilon() == j.accountant.epsilon()
    assert {n: list(q) for n, q in t.queue.items()} == {n: list(q) for n, q in j.queue.items()}
    assert t._queued == j._queued
    assert {n: s.value for n, s in t.state.items()} == {n: s.value for n, s in j.state.items()}
    for ledger in ("_retries", "_deferred", "_quarantine_until", "_peer_failures",
                   "_reputation", "_view_version", "_owner_clock", "_tick"):
        assert getattr(t, ledger) == getattr(j, ledger), ledger
    for n in t.trainers:
        for k, v in j.trainers[n].params.items():
            np.testing.assert_allclose(t.trainers[n].params[k].numpy(), np.asarray(v),
                                       rtol=0, atol=1e-5, err_msg=f"{n}.{k}")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Scheduler-level parity tests run thousands of small PyTorch ops. With
    several test workers on one machine, each op's intra-op thread team
    spins while it waits and the workers' teams starve each other (a run of
    these files that takes ~90 s on one thread each did not finish in 20
    minutes on eight); one thread per worker keeps them apart. Import this
    fixture into a test module to apply it there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
