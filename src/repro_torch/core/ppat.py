"""PPAT — privacy-preserving adversarial translation network (§3.2).

Structure (Fig. 3):
  client (g_i): generator G(X) = W·X, the MUSE-style translation matrix.
  host  (g_j): |T| teacher discriminators on disjoint partitions + one
               student discriminator trained with PATE noisy labels.

The privacy boundary is kept as in Alg. 2: per round the client ships only
``adv = G(X_b)`` (batch×d) to the host and the host ships only
``∂L_G/∂adv`` (batch×d) back. ``PPATClient`` and ``PPATHost`` expose exactly
that interface, and the fused loop ``ppat_scan_graph`` moves only those two
tensors between its client and host halves.

The teachers are stacked tensors — ``w1`` (T, d, h), ``b1`` (T, h), ``w2``
(T, h, 1), ``b2`` (T, 1) — and their losses are independent, so one
autograd call over their sum gives each teacher its own gradient (the JAX
package ``vmap``s ``value_and_grad``). The discriminator's activation
differentiates as ``jax.nn.leaky_relu`` does: slope 1 at exactly 0, where
``torch.nn.functional.leaky_relu`` gives 0.2.

Randomness is a seam. Every draw of a handshake is an input or comes from a
``torch.Generator``: the discriminators' init (or the weights carried across
with ``host_params_from_numpy``), and per round the client batch ids, the
host batch ids and the PATE Laplace noise (``PPATDraws``). The stepwise
loop samples its batches from the same numpy streams as the JAX package's
(``cfg.seed + 29`` for the client, ``cfg.seed + 17`` for the host).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pate import laplace_noise, pate_vote, teacher_votes
from repro_torch.core.privacy import MomentsAccountant
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kge.engine import as_device, bucket
from repro_torch.kge.models import params_from_numpy

Disc = Dict[str, torch.Tensor]
HostParams = Dict[str, Disc]


@dataclass(frozen=True)
class PPATConfig:
    """§4.1.1: batch 32, 4 teachers, lr 0.02, momentum 0.9; §4.1.2: λ=0.05."""

    batch: int = 32
    num_teachers: int = 4
    lr: float = 0.02
    momentum: float = 0.9
    hidden: int = 128
    steps: int = 200
    lam: float = 0.05
    delta: float = 1e-5
    ortho_beta: float = 0.001  # MUSE orthogonality stabilizer for W
    saturating: bool = False   # Eq. 3 verbatim (True) vs non-saturating fix
    seed: int = 0


class PPATDraws(NamedTuple):
    """One handshake's draws: per round the client batch ids ``idx``
    (steps, B) in [0, n_x), the host batch ids ``ridx`` (steps, B) in
    [0, n_y), and the standard Laplace noise of the PATE vote ``noise``
    (steps, 2, B)."""

    idx: torch.Tensor
    ridx: torch.Tensor
    noise: torch.Tensor


def draw_ppat(generator: torch.Generator, cfg: PPATConfig, n_x: int, n_y: int) -> PPATDraws:
    """A whole handshake's draws from ``generator``, on its device."""
    dev = generator.device
    shape = (cfg.steps, cfg.batch)
    idx = torch.randint(0, n_x, shape, generator=generator, device=dev)
    ridx = torch.randint(0, n_y, shape, generator=generator, device=dev)
    noise = laplace_noise(generator, (cfg.steps, 2, cfg.batch))
    return PPATDraws(idx, ridx, noise)


# ---------------------------------------------------------------- discriminators
def _init_disc(generator: torch.Generator, d: int, hidden: int, lead: Tuple[int, ...] = ()
               ) -> Disc:
    """A discriminator (``lead = (T,)``: T stacked ones) on the generator's
    device: normal weights over √fan-in, zero biases."""
    dev = generator.device
    return {
        "w1": torch.randn((*lead, d, hidden), generator=generator, device=dev) / math.sqrt(d),
        "b1": torch.zeros((*lead, hidden), device=dev),
        "w2": torch.randn((*lead, hidden, 1), generator=generator, device=dev)
        / math.sqrt(hidden),
        "b2": torch.zeros((*lead, 1), device=dev),
    }


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: ``where(x >= 0, x, 0.2·x)``, so the
    derivative at exactly 0 is 1 (PyTorch's own leaky_relu gives 0.2)."""
    return torch.where(x >= 0, x, 0.2 * x)


def _disc_prob(p: Disc, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid output of one discriminator on (N, d) rows → (N,), or of T
    stacked ones on (T, N, d) or shared (N, d) rows → (T, N)."""
    h = _leaky_relu(x @ p["w1"] + p["b1"].unsqueeze(-2))
    return torch.sigmoid((h @ p["w2"] + p["b2"].unsqueeze(-2))[..., 0])


def _sgd_momentum(params: Disc, grads, vel: Disc, lr: float, mom: float):
    new_vel = {k: mom * vel[k] + g for k, g in zip(params, grads)}
    new_params = {k: params[k] - lr * new_vel[k] for k in params}
    return new_params, new_vel


def _leaves(p: Disc) -> Disc:
    return {k: v.detach().requires_grad_(True) for k, v in p.items()}


# ---------------------------------------------------------------- host step
def _host_step_impl(host_params: HostParams, noise: torch.Tensor, adv: torch.Tensor,
                    real: torch.Tensor, cfg: PPATConfig):
    """One host round: teacher update (Eq. 4), PATE noisy votes on ``adv``
    (Eqs. 5–6), student update (Eq. 7), and ∂L_G/∂adv against the updated
    student (Eq. 3). ``adv`` (B, d) is the ONLY client input; ``real`` (B, d)
    never leaves the host; ``noise`` is the vote's (2, B) Laplace draws.
    Returns (new params, grad_adv (B, d), metrics, (n0, n1))."""
    t = cfg.num_teachers
    b, d = adv.shape
    per = b // t
    adv = adv.detach()
    adv_parts = adv[: per * t].reshape(t, per, d)
    real_parts = real[: per * t].reshape(t, per, d)

    # --- teacher update (Eq. 4): one autograd call over the T losses' sum --
    with torch.enable_grad():
        tp = _leaves(host_params["teachers"])
        pf = _disc_prob(tp, adv_parts)
        pr = _disc_prob(tp, real_parts)
        t_losses = -(torch.log(1 - pf + 1e-8).mean(-1) + torch.log(pr + 1e-8).mean(-1))
        t_grads = torch.autograd.grad(t_losses.sum(), list(tp.values()))
    with torch.no_grad():
        new_teachers, new_tvel = _sgd_momentum(
            host_params["teachers"], t_grads, host_params["teachers_vel"],
            cfg.lr, cfg.momentum,
        )
        # --- PATE voting on the full adv batch (Eqs. 5–6) ------------------
        votes = teacher_votes(_disc_prob(new_teachers, adv))  # (T, B)
        labels, n0, n1 = pate_vote(noise, votes, cfg.lam)

    # --- student update (Eq. 7): BCE on generated samples w/ noisy labels --
    with torch.enable_grad():
        sp = _leaves(host_params["student"])
        ps = _disc_prob(sp, adv)
        s_loss = -torch.mean(labels * torch.log(ps + 1e-8)
                             + (1 - labels) * torch.log(1 - ps + 1e-8))
        s_grads = torch.autograd.grad(s_loss, list(sp.values()))
    with torch.no_grad():
        new_student, new_svel = _sgd_momentum(
            host_params["student"], s_grads, host_params["student_vel"],
            cfg.lr, cfg.momentum,
        )

    # --- generator loss (Eq. 3) against the updated student; grad wrt adv --
    # non-saturating −log S(G(x)) by default; cfg.saturating restores the
    # verbatim log(1 − S(G(x)))
    with torch.enable_grad():
        a = adv.clone().requires_grad_(True)
        ps = _disc_prob(new_student, a)
        if cfg.saturating:
            g_loss = torch.mean(torch.log(1 - ps + 1e-8))
        else:
            g_loss = -torch.mean(torch.log(ps + 1e-8))
        (grad_adv,) = torch.autograd.grad(g_loss, a)

    new_params = {
        "teachers": new_teachers,
        "teachers_vel": new_tvel,
        "student": new_student,
        "student_vel": new_svel,
    }
    metrics = {
        "teacher_loss": t_losses.detach().mean(),
        "student_loss": s_loss.detach(),
        "gen_loss": g_loss.detach(),
        "vote_mean": labels.mean(),
    }
    return new_params, grad_adv, metrics, (n0, n1)


@torch.no_grad()
def _generator_update(w, vel, xb, grad_adv, cfg: PPATConfig):
    """Chain rule through G(X)=XW (∂L/∂W = Xᵀ·∂L/∂G(X)) + momentum SGD +
    MUSE orthogonalization — shared by the stepwise client and the fused loop."""
    gw = xb.T @ grad_adv
    vel = cfg.momentum * vel + gw
    w = w - cfg.lr * vel
    if cfg.ortho_beta:
        b = cfg.ortho_beta
        w = (1 + b) * w - b * (w @ w.T) @ w
    return w, vel


# ------------------------------------------------------------- fused loop
def _init_host_params(generator: torch.Generator, dim: int, cfg: PPATConfig) -> HostParams:
    """Teachers + student (+ zero momentum state) on the generator's device."""
    teachers = _init_disc(generator, dim, cfg.hidden, (cfg.num_teachers,))
    student = _init_disc(generator, dim, cfg.hidden)
    return {
        "teachers": teachers,
        "teachers_vel": {k: torch.zeros_like(v) for k, v in teachers.items()},
        "student": student,
        "student_vel": {k: torch.zeros_like(v) for k, v in student.items()},
    }


def host_params_from_numpy(host_params: Mapping[str, Mapping[str, np.ndarray]],
                           device=None) -> HostParams:
    """Carry the discriminators across from numpy (e.g. the JAX package's
    ``_init_host_params`` output, each leaf through ``np.asarray``):
    teachers, student and both velocities as float32 tensors on ``device``."""
    device = resolve_device(device)
    return {k: params_from_numpy(v, device) for k, v in host_params.items()}


def ppat_state_from_numpy(host_params, w, vel, device=None
                          ) -> Tuple[HostParams, torch.Tensor, torch.Tensor]:
    """The whole PPAT state carried across: (host params, W, its velocity)."""
    device = resolve_device(device)
    wv = params_from_numpy({"w": w, "vel": vel}, device)
    return host_params_from_numpy(host_params, device), wv["w"], wv["vel"]


def ppat_scan_graph(
    host_params: HostParams,
    w: torch.Tensor,
    vel: torch.Tensor,
    x: torch.Tensor,   # (Nx_pad, d) client embeddings (rows ≥ n_x are padding)
    y: torch.Tensor,   # (Ny_pad, d) host embeddings (rows ≥ n_y are padding)
    n_x: int,          # true row counts — sampling bounds
    n_y: int,
    cfg: PPATConfig,
    *,
    draws: Optional[PPATDraws] = None,
    generator: Optional[torch.Generator] = None,
):
    """Alg. 2: all ``cfg.steps`` adversarial rounds on ``x``'s device.

    Per round only ``adv = G(X_b)`` crosses to the host half and only
    ``∂L_G/∂adv`` crosses back. ``draws`` gives every round's batch ids and
    vote noise (the JAX package draws them from its key inside its scan);
    without it they come from ``generator``. Nothing is read back to the
    host: returns (host_params, w, vel, metrics {name: (steps,)}, n0s, n1s
    (steps, B)) on the device."""
    dev = x.device
    if draws is None:
        if generator is None:
            raise ValueError("ppat_scan_graph needs draws= or generator=")
        draws = draw_ppat(generator, cfg, n_x, n_y)
    idx, ridx, noise = (as_device(t, dev) for t in draws)
    want = (cfg.steps, cfg.batch)
    if tuple(idx.shape) != want or tuple(ridx.shape) != want or \
            tuple(noise.shape) != (cfg.steps, 2, cfg.batch):
        raise ValueError(f"ppat draws must be idx/ridx {want} and noise "
                         f"{(cfg.steps, 2, cfg.batch)}, got {tuple(idx.shape)}, "
                         f"{tuple(ridx.shape)}, {tuple(noise.shape)}")
    hist: Dict[str, list] = {"teacher_loss": [], "student_loss": [], "gen_loss": [],
                             "vote_mean": []}
    n0s, n1s = [], []
    for s in range(cfg.steps):
        xb = x[idx[s]]
        adv = xb @ w                                               # client → host
        host_params, grad_adv, metrics, (n0, n1) = _host_step_impl(
            host_params, noise[s], adv, y[ridx[s]], cfg)
        w, vel = _generator_update(w, vel, xb, grad_adv, cfg)      # host → client
        for k, v in metrics.items():
            hist[k].append(v)
        n0s.append(n0)
        n1s.append(n1)
    metrics = {k: torch.stack(v) for k, v in hist.items()}
    return host_params, w, vel, metrics, torch.stack(n0s), torch.stack(n1s)


def ppat_entry_graph(
    x: torch.Tensor,
    y: torch.Tensor,
    n_x: int,
    n_y: int,
    cfg: PPATConfig,
    *,
    init: Optional[HostParams] = None,
    draws: Optional[PPATDraws] = None,
    generator: Optional[torch.Generator] = None,
):
    """One complete handshake: discriminator init (or ``init``, carried
    across) + all adversarial rounds, W starting at the identity. Returns
    (host_params, w, metrics, n0s, n1s)."""
    dim = x.shape[1]
    if init is None:
        if generator is None:
            raise ValueError("ppat_entry_graph needs init= or generator=")
        init = _init_host_params(generator, dim, cfg)
    w = torch.eye(dim, dtype=torch.float32, device=x.device)
    vel = torch.zeros_like(w)
    host_params, w, _, metrics, n0s, n1s = ppat_scan_graph(
        init, w, vel, x, y, n_x, n_y, cfg, draws=draws, generator=generator)
    return host_params, w, metrics, n0s, n1s


class PPATHost:
    """g_j side: all discriminators + the moments accountant (§3.2.2).
    ``generator`` draws the init (unless ``params`` carries it across) and
    the vote noise of rounds that are not given theirs."""

    def __init__(self, generator: Optional[torch.Generator], dim: int, y: torch.Tensor,
                 cfg: PPATConfig, *, params: Optional[HostParams] = None):
        self.cfg = cfg
        self.y = y  # host embeddings of aligned entities/relations — private
        self._gen = generator
        self.params = params if params is not None else _init_host_params(generator, dim, cfg)
        self.accountant = MomentsAccountant(cfg.lam, cfg.delta)
        self._rng = np.random.default_rng(cfg.seed + 17)

    def step(self, adv: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Receive generated samples; return ∂L_G/∂adv + public metrics."""
        idx = self._rng.integers(0, len(self.y), len(adv))
        real = self.y[torch.as_tensor(idx, device=self.y.device)]
        if noise is None:
            noise = laplace_noise(self._gen, (2, len(adv)))
        self.params, grad_adv, metrics, (n0, n1) = _host_step_impl(
            self.params, as_device(noise, adv.device), adv, real, self.cfg)
        self.accountant.update(n0.cpu().numpy(), n1.cpu().numpy())
        return grad_adv, {k: float(v) for k, v in metrics.items()}


class PPATClient:
    """g_i side: the translation matrix W (= θ_G) and its optimizer."""

    def __init__(self, dim: int, x: torch.Tensor, cfg: PPATConfig):
        self.cfg = cfg
        self.x = x  # client embeddings of aligned entities/relations — private
        self.w = torch.eye(dim, dtype=torch.float32, device=x.device)
        self.vel = torch.zeros_like(self.w)
        self._rng = np.random.default_rng(cfg.seed + 29)

    def sample_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        idx = self._rng.integers(0, len(self.x), self.cfg.batch)
        xb = self.x[torch.as_tensor(idx, device=self.x.device)]
        return xb, self.generate(xb)

    @torch.no_grad()
    def generate(self, xb: torch.Tensor) -> torch.Tensor:
        return xb @ self.w

    def apply_grad(self, xb: torch.Tensor, grad_adv: torch.Tensor) -> None:
        """Chain rule through G(X)=XW: ∂L/∂W = Xᵀ·∂L/∂G(X)."""
        self.w, self.vel = _generator_update(self.w, self.vel, xb, grad_adv, self.cfg)


#: aligned sets are zero-padded up to this row granularity, as the JAX
#: package pads them for its compiled loop; zero rows stay zero through
#: ``generate`` and add nothing to the procrustes product
PPAT_BUCKET = 64


def _pad_rows(a: torch.Tensor, granularity: int) -> torch.Tensor:
    n_pad = bucket(a.shape[0], granularity)
    if n_pad == a.shape[0]:
        return a
    return torch.cat([a, a.new_zeros((n_pad - a.shape[0], *a.shape[1:]))])


def _on_device(a, device) -> torch.Tensor:
    if torch.is_tensor(a) and device is None:
        return a.float()
    return as_device(a, resolve_device(device)).float()


def train_ppat(
    x,
    y,
    cfg: Optional[PPATConfig] = None,
    *,
    generator: Optional[torch.Generator] = None,
    init: Optional[HostParams] = None,
    draws: Optional[PPATDraws] = None,
    fused: bool = True,
    device=None,
) -> Tuple[PPATClient, PPATHost, Dict]:
    """Run Alg. 2 between a client embedding set X and host set Y.

    Returns the trained (client, host) pair and a history dict; the caller
    obtains DP-synthesized embeddings via ``client.generate(...)`` and the
    privacy estimate via ``host.accountant.epsilon()``.

    Runs on ``x``'s device when ``x`` is a tensor, else on ``device`` (the
    current CUDA device by default; ``device="cpu"`` for the CPU).
    ``generator`` (default: seeded ``cfg.seed`` on that device) draws what
    ``init`` (the discriminators, see ``host_params_from_numpy``) and
    ``draws`` (``PPATDraws``) do not give.

    ``fused=True`` runs all rounds in ``ppat_scan_graph`` with device-side
    sampling and reads the metrics and vote counts back once at the end;
    the accountant takes the clean-vote history ``(steps, B)`` row-major in
    one update; the history also holds those counts (``n0``, ``n1``, int32
    (steps, B)). ``fused=False`` is the stepwise loop: one round-trip per
    round, batches from the numpy streams; ``draws`` then only supplies the
    vote noise.
    """
    cfg = cfg or PPATConfig()
    if x.shape[0] == 0 or y.shape[0] == 0:
        raise ValueError("train_ppat needs non-empty aligned sets "
                         f"(got |X|={x.shape[0]}, |Y|={y.shape[0]})")
    x = _on_device(x, device)
    y = _on_device(y, x.device if device is None else device)
    dev = x.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    dim = x.shape[1]
    client = PPATClient(dim, x, cfg)
    history = {"gen_loss": [], "student_loss": [], "teacher_loss": []}
    if fused:
        host = PPATHost.__new__(PPATHost)
        host.cfg, host.y, host._gen = cfg, y, generator
        host.accountant = MomentsAccountant(cfg.lam, cfg.delta)
        host._rng = np.random.default_rng(cfg.seed + 17)
        host.params, client.w, metrics, n0s, n1s = ppat_entry_graph(
            _pad_rows(x, PPAT_BUCKET), _pad_rows(y, PPAT_BUCKET),
            x.shape[0], y.shape[0], cfg, init=init, draws=draws, generator=generator,
        )
        # ONE device→host read for the whole run
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        for k in history:
            history[k] = [float(v) for v in metrics[k]]
        history["n0"], history["n1"] = n0s.cpu().numpy(), n1s.cpu().numpy()
        host.accountant.update(history["n0"].ravel(), history["n1"].ravel())
    else:
        host = PPATHost(generator, dim, y, cfg, params=init)
        for s in range(cfg.steps):
            xb, adv = client.sample_batch()                  # client → host: adv only
            noise = None if draws is None else draws.noise[s]
            grad_adv, metrics = host.step(adv, noise)        # host → client: grads only
            client.apply_grad(xb, grad_adv)
            for k in history:
                history[k].append(metrics[k])
    history["epsilon"] = host.accountant.epsilon()
    history["max_alpha"] = host.accountant.max_alpha()
    return client, host, history


@torch.no_grad()
def noisy_vote_labels(
    host_params: HostParams,
    rows: torch.Tensor,
    lam: float,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    rounds: int = 1,
) -> np.ndarray:
    """The PATE vote channel as an attacker-facing query surface: the mean
    noisy vote label of the trained teachers on ``rows`` over ``rounds``
    independent Laplace draws, shape ``(len(rows),)`` in [0, 1]. ``noise``
    (rounds, 2, len(rows)) gives the draws, else ``generator`` does."""
    votes = teacher_votes(_disc_prob(host_params["teachers"], rows))
    n = rows.shape[0]
    if noise is None:
        if generator is None:
            raise ValueError("noisy_vote_labels needs noise= or generator=")
        noise = laplace_noise(generator, (rounds, 2, n))
    noise = as_device(noise, rows.device)
    labels = [pate_vote(noise[i], votes, lam)[0].cpu().numpy().astype(np.float64)
              for i in range(rounds)]
    return np.mean(labels, axis=0)
