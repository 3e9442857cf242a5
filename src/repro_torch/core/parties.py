"""The paper's two-party topology on ``torch.distributed``: the port of the
JAX package's party mesh (``make_party_mesh``, ``init_distributed_ppat``,
``ppat_exchange_step`` and ``make_sharded_kge_step`` in its
``core/distributed.py``).

Each party is a process of one process group (``make_party_group``); rank 0
is the client and rank 1 the host, as on the JAX package's ``party`` axis.
``run_parties`` spawns the ranks and gathers what each returns.

**The pipe.** One PPAT round moves exactly two (B, d) tensors: the client's
generated rows ``adv = X_b·W`` to the host and ``∂L_G/∂adv`` back. Each
role's state stays in its own process: the host keeps the discriminators,
the client keeps W. (The JAX program also copies every role's state to the
other party after each round, a collective-permute per leaf; the port does
not, and computes the same rounds.) ``PartyGroup.traffic`` counts what a
rank hands to the backend for other ranks, so a run can show it.

**Backends.** The caller names the backend. ``nccl`` needs one card per
rank. Under ``gloo`` several ranks may share one card; gloo's
point-to-point calls take host tensors only, so a party on a card stages
every tensor it communicates through a pinned host buffer (``_to_wire``):
a copy, so the values arrive bit for bit.

**The sharded KGE step.** Rank r holds rows ``[r·E/W, (r+1)·E/W)`` of
``ent`` and a replica of ``rel``. Every rank is passed the same global
batch, so each knows which rows every other rank needs from it: the rows
go out in one ``all_to_all`` (fixed slots, zero where another rank owns
the row), and their gradients come back the same way to be summed per row
on the owner. The relation gradients of each rank's slots are all-gathered
and added in the same order on every rank. A step moves O(B·d) bytes,
whatever E and R are; no rank ever holds the whole entity table.
"""
from __future__ import annotations

import collections
import datetime
import queue
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.ppat import (
    PPATConfig,
    _generator_update,
    _host_step_impl,
    _init_host_params,
)
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kge.engine import as_device
from repro_torch.kge.models import KGEModel, margin_loss, score_triples

CLIENT, HOST = 0, 1
BACKENDS = ("gloo", "nccl")
#: families whose tables are exactly ``ent`` and ``rel``, the two the JAX
#: package's sharded step lays out
SHARDED_FAMILIES = ("transe", "distmult")
HOST_KEYS = ("teachers", "teachers_vel", "student", "student_vel")
CLIENT_KEYS = ("w", "w_vel")


@dataclass
class Traffic:
    """What one rank handed to the backend for other ranks: tensors, bytes
    (an ``all_to_all`` counts the blocks addressed to other ranks, a
    gather or reduce the whole local tensor), the count of each
    ``dtype[shape]`` sent, and the host-clock seconds spent in the calls,
    waiting for peers included."""

    tensors: int = 0
    bytes: int = 0
    seconds: float = 0.0
    shapes: Dict[str, int] = field(default_factory=collections.Counter)

    def note(self, t: torch.Tensor, n: int = 1, nbytes: Optional[int] = None) -> None:
        self.tensors += n
        self.bytes += t.numel() * t.element_size() if nbytes is None else nbytes
        self.shapes[f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"] += n

    def snapshot(self) -> Dict[str, Any]:
        return {"tensors": self.tensors, "bytes": self.bytes, "seconds": self.seconds,
                "shapes": dict(self.shapes)}


class PartyGroup:
    """One rank's view of the party group: its rank, the world size, the
    device it computes on, the backend, and its ``traffic``. A group of one
    party needs no process group: its collectives return their input."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.backend = backend
        self.traffic = Traffic()
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    @property
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _buffer(self, slot: str, shape, dtype) -> torch.Tensor:
        key = (slot, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def _to_wire(self, t: torch.Tensor, slot: str) -> torch.Tensor:
        """A contiguous copy of ``t`` the backend may overwrite: under gloo a
        pinned host buffer (a blocking copy, so it holds ``t``'s values when
        this returns), else a device copy."""
        if self._staged:
            return self._buffer(slot, t.shape, t.dtype).copy_(t)
        return t.clone(memory_format=torch.contiguous_format)

    def _from_wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def _empty(self, slot: str, shape, dtype) -> torch.Tensor:
        if self._staged:
            return self._buffer(slot, shape, dtype)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _need_peers(self, what: str) -> None:
        if self.world < 2:
            raise ValueError(f"{what} needs a peer; this group has one party")

    def send(self, t: torch.Tensor, dst: int) -> None:
        """Send ``t`` to rank ``dst`` (blocks until the buffer is handed over)."""
        self._need_peers("send")
        t0 = time.perf_counter()
        dist.send(self._to_wire(t, "send"), dst)
        self.traffic.seconds += time.perf_counter() - t0
        self.traffic.note(t)

    def recv(self, shape, src: int, dtype=torch.float32) -> torch.Tensor:
        """Receive a ``dtype[shape]`` tensor from rank ``src`` onto this
        rank's device."""
        self._need_peers("recv")
        t0 = time.perf_counter()
        buf = self._empty("recv", shape, dtype)
        dist.recv(buf, src)
        out = self._from_wire(buf)
        self.traffic.seconds += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (W, ...): block k goes to rank k; returns (W, ...) whose
        block k came from rank k."""
        if t.shape[0] != self.world:
            raise ValueError(f"all_to_all takes ({self.world}, ...) blocks, got {tuple(t.shape)}")
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        inp = self._to_wire(t, "a2a_in")
        out = self._empty("a2a_out", t.shape, t.dtype)
        dist.all_to_all_single(out, inp)
        out = self._from_wire(out)
        self.traffic.seconds += time.perf_counter() - t0
        self.traffic.note(t[0], self.world - 1, (self.world - 1) * t[0].numel() * t.element_size())
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: (W, *t.shape)."""
        if self.world == 1:
            return t.unsqueeze(0)
        t0 = time.perf_counter()
        inp = self._to_wire(t, "gather_in")
        outs = [self._empty(f"gather_out{k}", t.shape, t.dtype) for k in range(self.world)]
        dist.all_gather(outs, inp)
        out = torch.stack([self._from_wire(o) for o in outs])
        self.traffic.seconds += time.perf_counter() - t0
        self.traffic.note(t)
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        if self.world == 1:
            return t
        t0 = time.perf_counter()
        buf = self._to_wire(t, "reduce")
        dist.all_reduce(buf)
        out = self._from_wire(buf).clone()
        self.traffic.seconds += time.perf_counter() - t0
        self.traffic.note(t)
        return out

    def close(self) -> None:
        if self.world > 1 and dist.is_initialized():
            dist.destroy_process_group()


def make_party_group(rank: int, world: int, *, backend: str, init_method: Optional[str] = None,
                     device=None, timeout: float = 120.0) -> PartyGroup:
    """Join the party group as ``rank`` of ``world``: the counterpart of the
    JAX package's ``make_party_mesh``, one process per party.

    ``init_method`` is the rendezvous (``file://...`` or
    ``tcp://host:port``), needed when ``world > 1``. ``backend`` is
    ``"gloo"`` or ``"nccl"``; ``nccl`` needs a card per rank. Rank r
    computes on ``cuda:(r % cards)`` unless ``device`` says otherwise
    (``device="cpu"`` for the CPU); with no card and no ``device`` this
    raises. Every collective gives up after ``timeout`` seconds, so a dead
    peer fails the run."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; name one of {BACKENDS}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a group of {world}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        if cards == 0:
            raise RuntimeError("no CUDA device available; pass device='cpu' to run the "
                               "parties on the CPU")
        device = torch.device("cuda", rank % cards)
    device = resolve_device(device)
    if backend == "nccl" and (device.type != "cuda" or cards < world):
        raise RuntimeError(f"nccl needs one card per rank: {world} ranks, {cards} cards, "
                           f"rank {rank} on {device}; name gloo to share a card or the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        if init_method is None:
            raise ValueError("a group of more than one party needs an init_method")
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
    return PartyGroup(rank, world, device, backend)


# ------------------------------------------------------------------ launcher
def _to_host(obj):
    """Tensors (nested in dicts, lists, tuples) as numpy arrays, traffic as
    a dict: what a rank returns crosses to the parent by pickle."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, Traffic):
        return obj.snapshot()
    if isinstance(obj, Mapping):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _party_main(rank, world, fn, args, group_kw, threads, results) -> None:
    torch.set_num_threads(threads)
    try:
        group = make_party_group(rank, world, **group_kw)
        out = _to_host(fn(group, *args))
        group.close()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def _build_kernels() -> None:
    """Build every kernel library of the port once, in the parent, so two
    ranks never run ``nvcc`` on one build directory."""
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.csls import ops as csls_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.sparse_update import ops as step_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.triple_score import ops as score_ops

    _nvcc.build_all(score_ops.LIBRARIES + step_ops.LIBRARIES + csls_ops.LIBRARIES
                    + flash_ops.LIBRARIES + ssd_ops.LIBRARIES)


def run_parties(fn: Callable, world: int, *args, backend: str, init_method: str,
                device=None, timeout: float = 120.0) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks and return what
    each returned, in rank order (tensors as numpy arrays).

    ``fn`` and ``args`` are pickled: ``fn`` must be importable (a module's
    top-level function). ``backend``, ``init_method``, ``device`` and
    ``timeout`` go to ``make_party_group``. Each rank runs with an equal
    share of this process's intra-op threads (at least one). A rank that
    raises or dies fails the run: its traceback is raised here with its
    rank named, and the other ranks are stopped."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run the "
                               "parties on the CPU")
        _build_kernels()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    group_kw = dict(backend=backend, init_method=init_method, device=device, timeout=timeout)
    # the ranks share this process's intra-op threads: more would spin
    # against each other on the same cores
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_party_main, name=f"party-{rank}",
                         args=(rank, world, fn, args, group_kw, threads, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    try:
        quiet_since = None
        while len(out) < world:
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if not gone:
                    continue
                # a rank that exited may still have a message in flight
                quiet_since = quiet_since or time.monotonic()
                if time.monotonic() - quiet_since > 10.0:
                    r = gone[0]
                    raise RuntimeError(f"party rank {r} of {world} exited with code "
                                       f"{procs[r].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"party rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"party ranks exited non-zero (rank, code): {bad}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


# ------------------------------------------------------------------ PPAT
def init_distributed_ppat(generator: torch.Generator, dim: int, cfg: PPATConfig
                          ) -> Dict[str, Any]:
    """The whole exchange state on the generator's device, with the JAX
    package's keys: the host's teachers (stacked on a leading T axis),
    student and their velocities, the client's W = I and its velocity."""
    state: Dict[str, Any] = dict(_init_host_params(generator, dim, cfg))
    state["w"] = torch.eye(dim, dtype=torch.float32, device=generator.device)
    state["w_vel"] = torch.zeros((dim, dim), dtype=torch.float32, device=generator.device)
    return state


def distributed_ppat_state_from_numpy(state: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """Carry an exchange state across (e.g. the JAX package's
    ``init_distributed_ppat`` output, each leaf through ``np.asarray``), or
    move one: float32 tensors on ``device``. Keys it lacks stay absent, so
    a role's half carries across on its own."""
    device = resolve_device(device)

    def put(v):
        return as_device(v, device).to(torch.float32).contiguous()

    return {k: ({n: put(a) for n, a in v.items()} if isinstance(v, Mapping) else put(v))
            for k, v in state.items()}


def role_state(state: Mapping[str, Any], rank: int) -> Dict[str, Any]:
    """The half of an exchange state that ``rank`` keeps: the client's W and
    its velocity, or the host's discriminators."""
    return {k: state[k] for k in (CLIENT_KEYS if rank == CLIENT else HOST_KEYS)}


def ppat_exchange_step(group: PartyGroup, cfg: PPATConfig) -> Callable:
    """One PPAT round for this rank of a two-party group, the counterpart of
    the JAX package's ``ppat_exchange_step``.

    The client's step ``(state, xb) → (state, None, None)`` sends
    ``adv = xb·W`` and applies the gradient it gets back (``ppat.
    _generator_update``, MUSE orthogonalisation included). The host's step
    ``(state, yb, noise) → (state, metrics, (n0, n1))`` takes the round's
    (2, B) Laplace draws, runs ``ppat._host_step_impl`` on the received
    rows and sends ``∂L_G/∂adv`` back; ``n0``/``n1`` are the clean vote
    counts for the accountant. The two (B, d) tensors are all that cross."""
    if group.world != 2:
        raise ValueError(f"the exchange runs between two parties, not {group.world}")
    if group.rank == CLIENT:
        def client_step(state, xb, noise=None):
            xb = as_device(xb, group.device)
            if xb.shape[0] != cfg.batch:
                raise ValueError(f"the client's batch has {xb.shape[0]} rows, not {cfg.batch}")
            with torch.no_grad():
                adv = xb @ state["w"]
            group.send(adv, HOST)
            grad_adv = group.recv(tuple(adv.shape), HOST)
            w, vel = _generator_update(state["w"], state["w_vel"], xb, grad_adv, cfg)
            return {"w": w, "w_vel": vel}, None, None
        return client_step

    def host_step(state, yb, noise):
        if noise is None:
            raise ValueError("the host's step needs the vote's (2, B) Laplace draws")
        yb = as_device(yb, group.device)
        adv = group.recv((cfg.batch, yb.shape[1]), CLIENT)
        new, grad_adv, metrics, votes = _host_step_impl(
            state, as_device(noise, group.device), adv, yb, cfg)
        group.send(grad_adv, CLIENT)
        return new, metrics, votes
    return host_step


def exchange_party(group: PartyGroup, cfg: PPATConfig, state: Mapping[str, Any],
                   xbs, ybs, noise) -> Dict[str, Any]:
    """``len(xbs)`` exchange rounds on this rank from a whole state (numpy
    or tensors; the rank keeps its half): the client reads ``xbs``
    (rounds, B, d), the host ``ybs`` and ``noise`` (rounds, 2, B); the other
    side's may be ``None``. Returns the rank's final half, its traffic, and
    on the host every round's metrics and clean vote counts (rounds, B)."""
    mine = distributed_ppat_state_from_numpy(role_state(state, group.rank), group.device)
    step = ppat_exchange_step(group, cfg)
    batches = xbs if group.rank == CLIENT else ybs
    hist: Dict[str, list] = collections.defaultdict(list)
    for s in range(len(batches)):
        mine, metrics, votes = step(mine, batches[s], None if noise is None else noise[s])
        if metrics is not None:
            for k, v in metrics.items():
                hist[k].append(v)
            hist["n0"].append(votes[0])
            hist["n1"].append(votes[1])
    return {"state": mine, "traffic": group.traffic,
            "history": {k: torch.stack(v) for k, v in hist.items()}}


# ------------------------------------------------------------------ sharded KGE
def _shard_rows(num_entities: int, group: PartyGroup) -> Tuple[int, int]:
    if num_entities % group.world:
        raise ValueError(f"the entity table's {num_entities} rows do not split over "
                         f"{group.world} ranks; pad it to a multiple of {group.world}")
    rows = num_entities // group.world
    return group.rank * rows, rows


def shard_params(params: Mapping[str, Any], group: PartyGroup) -> Dict[str, torch.Tensor]:
    """This rank's shard of whole tables (numpy or tensors): its block of
    ``ent``'s rows and a copy of ``rel``, float32 on the group's device."""
    if set(params) != {"ent", "rel"}:
        raise ValueError(f"the sharded step takes exactly ent and rel, got {sorted(params)}")
    lo, rows = _shard_rows(params["ent"].shape[0], group)

    def put(v):
        return as_device(v, group.device).to(torch.float32).clone(
            memory_format=torch.contiguous_format)

    return {"ent": put(params["ent"][lo:lo + rows]), "rel": put(params["rel"])}


def gather_params(shard: Mapping[str, torch.Tensor], group: PartyGroup
                  ) -> Dict[str, torch.Tensor]:
    """The whole tables from every rank's shard (every rank gets them): for
    carrying trained tables out and comparing them, never used by a step."""
    ent = group.all_gather(shard["ent"])
    return {"ent": ent.reshape(-1, ent.shape[-1]), "rel": shard["rel"]}


def make_sharded_kge_step(group: PartyGroup, model: KGEModel, *, lr: float) -> Callable:
    """The margin-SGD step over entity rows sharded across the group, the
    counterpart of the JAX package's ``make_sharded_kge_step``:
    ``step(shard, pos, neg) → (shard, loss)``, in place on ``shard``.

    Every rank is passed the same global (B, 3) batches (numpy or tensors)
    and scores its contiguous block of B/W triples with ``score_triples``
    and ``margin_loss``, scaled so the loss is the mean over the global
    batch; ``loss`` is that mean, the same on every rank."""
    if model.family not in SHARDED_FAMILIES:
        raise ValueError(f"the sharded step takes {SHARDED_FAMILIES}, whose tables are ent "
                         f"and rel; {model.family!r} has more")
    world, rank, dev = group.world, group.rank, group.device
    lo, rows = _shard_rows(model.num_entities, group)
    ranks = torch.arange(world, device=dev)

    def step(shard, pos, neg):
        pos, neg = (as_device(t, dev).to(torch.int64) for t in (pos, neg))
        b = pos.shape[0]
        if b % world or pos.shape != neg.shape:
            raise ValueError(f"the batch of {b} triples does not split over {world} ranks "
                             f"(negatives {tuple(neg.shape)})")
        bl = b // world
        ent, rel = shard["ent"], shard["rel"]
        # every rank's entity slots, rank-major: its block's pos heads, pos
        # tails, neg heads, neg tails
        ids = torch.stack([pos[:, 0], pos[:, 2], neg[:, 0], neg[:, 2]]).view(4, world, bl)
        ids = ids.transpose(0, 1).reshape(world, 4 * bl)
        local = ids - lo
        owned = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        rows_out = torch.where(owned.unsqueeze(-1), ent[local], 0.0)
        rows_in = group.all_to_all(rows_out)        # block o: owner o's rows for my slots
        owner = torch.div(ids[rank], rows, rounding_mode="floor")
        slots = torch.arange(4 * bl, device=dev)
        rel_ids = torch.cat([pos[:, 1].view(world, bl), neg[:, 1].view(world, bl)], dim=1)
        with torch.enable_grad():
            emb = rows_in[owner, slots].requires_grad_(True)
            rel_rows = rel[rel_ids[rank]].requires_grad_(True)
            ph, pt, nh, nt = emb.split(bl)
            tables = {"ent": emb, "rel": rel_rows}
            sp = score_triples(tables, model, None, slots[:bl], None, h_emb=ph, t_emb=pt)
            sn = score_triples(tables, model, None, slots[bl:2 * bl], None, h_emb=nh, t_emb=nt)
            loss = margin_loss(sp, sn, model.margin) * (bl / b)
            g_emb, g_rel = torch.autograd.grad(loss, (emb, rel_rows))
        # row gradients back to their owners, summed per row there
        grads_out = torch.where((owner.unsqueeze(0) == ranks.unsqueeze(1)).unsqueeze(-1),
                                g_emb.unsqueeze(0), 0.0)
        grads_in = group.all_to_all(grads_out)      # block s: requester s's grads, mine or 0
        ent.index_add_(0, local.reshape(-1), grads_in.reshape(-1, ent.shape[1]), alpha=-lr)
        rel_all = group.all_gather(g_rel)
        rel.index_add_(0, rel_ids.reshape(-1), rel_all.reshape(-1, rel.shape[1]), alpha=-lr)
        return shard, group.all_reduce(loss.detach().reshape(1))[0]

    return step


def sharded_party(group: PartyGroup, model: KGEModel, lr: float, params: Mapping[str, Any],
                  pos, neg) -> Dict[str, Any]:
    """``len(pos)`` sharded steps on this rank from whole tables (numpy or
    tensors) over global batches ``pos``/``neg`` (steps, B, 3). Returns
    every step's loss, the traffic of the steps alone, the bytes of this
    rank's shard, and the gathered tables (on rank 0 only)."""
    shard = shard_params(params, group)
    step = make_sharded_kge_step(group, model, lr=lr)
    group.traffic = Traffic()
    losses = [step(shard, pos[s], neg[s])[1] for s in range(len(pos))]
    traffic = group.traffic.snapshot()
    full = gather_params(shard, group)
    return {"losses": torch.stack(losses), "traffic": traffic,
            "shard_bytes": sum(t.numel() * t.element_size() for t in shard.values()),
            "params": full if group.rank == 0 else None}
