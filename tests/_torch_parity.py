"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: seeded inputs made with numpy, dyadic tables on which fp32 sums
are exact in any order, and the near-tie rule for rank counts."""
import jax
import numpy as np

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

    def ppat(self, host, client, n_x: int, n_y: int):
        import torch

        from repro_torch.core.ppat import PPATDraws, host_params_from_numpy

        self._key, key = jax.random.split(self._key)
        init = host_params_from_numpy(jax_ppat_init(key, self.dim, self.cfg), "cpu")
        draws = jax_ppat_draws(key, self.cfg, n_x, n_y)
        return init, PPATDraws(*(torch.as_tensor(a) for a in draws))

    def train(self, owner, epochs: int, n_pad: int, nb: int, batch: int, num_entities: int):
        self._engine[owner], sub = jax.random.split(self._engine[owner])
        return jax_draws(sub, epochs, n_pad, nb, batch, num_entities)
