"""npz checkpointing of nested dicts and lists of tensors (no external deps),
in the JAX package's layout: leaves are path-keyed (``trainers/A/params/ent``,
a list's items by index: ``layers/0/attn/wq/w``, as the reference's
``_key_str``) and a ``__metadata__`` entry holds a JSON sidecar, so a
checkpoint written by either package loads in the other. bf16 leaves are
stored as the reference stores them: numpy has no bfloat16, so ``np.savez``
writes their two bytes as ``|V2``; loading reads those bytes back as bf16.

An LM's parameters go through ``models.lm_params_to_numpy`` (the
reference's tree: ``embed/table``, ``layers/<p>/…`` stacks per period
position) and come back with ``lm_params_from_numpy``; ``save_lm`` and
``load_lm`` do both.

``save_scheduler`` / ``restore_scheduler`` give crash-consistent
federation resume: everything the scheduler's decisions depend on — queues,
node states, the tick counter, best scores, every random stream, the
moments accountant, the retry/backoff/quarantine ledger, reputation, the
adversary's replay cache, the per-owner clocks and view versions, and the
accepted tables — round-trips exactly, so a run cut between ticks (or
between streamed passes, which complete whole) resumes with bit-identical
decisions and tables.

The random streams are the port's, where the JAX package stores keys: the
scheduler's PPAT ``torch.Generator`` state at ``key``, each trainer's engine
generator state at ``trainers/<n>/key`` and its numpy ``rng`` state in the
sidecar (``rng``), and the state of a ``draws=`` source (``state_dict()``)
under ``draws/``. A generator state belongs to its device type (a CUDA
state does not load into a CPU generator), so restoring into a scheduler of
another device type works only when both draw from a ``draws=`` source,
whose state is device-free; otherwise it raises. The sidecar's
``placement`` holds the batched engine's sticky owner slots, so a resumed
run homes every owner where the interrupted one did.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _numpy(v) -> np.ndarray:
    if not torch.is_tensor(v):
        return np.asarray(v)
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:  # the bytes, as np.savez writes a JAX bf16 leaf
        return v.contiguous().view(torch.int16).numpy().view("V2")
    return v.numpy()


def _items(tree: Any):
    """(key, child) of a dict or, by index, a list or tuple; None for a leaf."""
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/0/b": leaf}`` for nested dicts and lists of leaves."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``like``'s structure (dicts and lists) with the leaf at each path."""
    items = _items(like)
    if items is None:
        return leaves[prefix]
    out = {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k)) for k, v in items}
    return out if isinstance(like, dict) else type(like)(out[i] for i in range(len(like)))


def _unflatten(flat: Dict[str, Any]) -> Dict:
    """The nested dicts of flattened ``{"a/b": leaf}``."""
    root: Dict = {}
    for path, leaf in flat.items():
        node = root
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return root


def _np_dtype(ref) -> np.dtype:
    if isinstance(ref.dtype, torch.dtype):
        return torch.empty(0, dtype=ref.dtype).numpy().dtype
    return np.dtype(ref.dtype)


def save_checkpoint(path: str, tree: Any, *, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (nested dicts of tensors or arrays) to ``path``
    atomically (tmp + rename)."""
    arrays = {k: _numpy(v) for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __metadata__=json.dumps(metadata or {}), **arrays)
    os.replace(tmp, path)


def _is_bf16(dtype) -> bool:
    return dtype == torch.bfloat16 or getattr(dtype, "name", None) == "bfloat16"


def _leaf(arr: np.ndarray, ref) -> torch.Tensor:
    """A stored array as a tensor of ``ref``'s dtype; ``|V2`` leaves (and
    any leaf loaded into bf16) go through a bf16 tensor."""
    if arr.dtype.kind != "V" and not _is_bf16(ref.dtype):
        return torch.from_numpy(np.array(arr, dtype=_np_dtype(ref), order="C"))
    t = (torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
         if arr.dtype.kind == "V" else torch.from_numpy(np.array(arr, dtype=np.float32)))
    return t.to(torch.bfloat16 if _is_bf16(ref.dtype)
                else torch.from_numpy(np.empty(0, _np_dtype(ref))).dtype)


def load_checkpoint(path: str, like: Any, *, device=None) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (nested dicts and lists of
    tensors, or of anything with ``shape`` and ``dtype``), every leaf
    checked against its shape and cast to its dtype. Leaves come back as
    tensors on ``device`` (the CPU by default)."""
    leaves = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__metadata__"]))
        for key, ref in _flatten(like).items():
            if key not in z:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = z[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(ref.shape)}")
            leaves[key] = _leaf(arr, ref)
            if device is not None:
                leaves[key] = leaves[key].to(device)
    return _rebuild(like, leaves), meta


def save_lm(path: str, cfg, model, *, metadata: Optional[Dict] = None) -> None:
    """``model``'s parameters in the reference's LM layout (the tree of
    ``models.lm_tree``), as ``repro.launch.train`` saves ``state.params``."""
    from repro_torch.models.model import lm_tree

    save_checkpoint(path, lm_tree(cfg, model, "tensor"), metadata=metadata)


def load_lm(path: str, cfg, model) -> Dict:
    """Load an LM checkpoint in the reference's layout (written by either
    package) into ``model`` → its metadata. Leaves are read in the model's
    dtypes and land on its device."""
    from repro_torch.models.model import lm_params_from_numpy, lm_tree

    tree, meta = load_checkpoint(path, lm_tree(cfg, model, "spec"))
    model.load_state_dict(lm_params_from_numpy(cfg, tree))
    return meta


# ---------------------------------------------------------------------------
# crash-consistent federation scheduler resume
# ---------------------------------------------------------------------------
def _draw_source_state(sched) -> Dict:
    src = sched._draws
    if src is None:
        return {}
    if not (hasattr(src, "state_dict") and hasattr(src, "load_state_dict")):
        raise ValueError(
            f"the scheduler's draw source {type(src).__name__} has no state_dict/"
            "load_state_dict: a checkpoint of it could not resume bit-identically")
    return {k: _numpy(v) for k, v in _flatten(src.state_dict()).items()}


def _scheduler_tree(sched, draws: Dict, stale: Dict) -> Dict:
    """The scheduler's array-valued state. One table copy per owner: at a
    tick boundary ``trainer.params`` equals ``best_snapshot`` (accept copies
    params into the snapshot, reject copies the snapshot into params)."""
    return {
        "key": sched._ppat_gen.get_state(),
        "trainers": {
            n: {"params": dict(sched.best_snapshot[n]), "key": tr._gen.get_state()}
            for n, tr in sched.trainers.items()
        },
        "adversary": stale,
        "draws": draws,
    }


def save_scheduler(path: str, sched, *, metadata: Optional[Dict] = None) -> None:
    """Checkpoint a ``FederationScheduler`` between ticks (atomic tmp +
    rename). Mid-tick state (BUSY owners), a scheduler before
    ``initial_training`` and a draw source without ``state_dict`` are
    refused. Scalar protocol state rides in the JSON sidecar under the JAX
    package's field names (floats round-trip exactly through ``repr``)."""
    from repro_torch.core.federation import NodeState

    if any(s is NodeState.BUSY for s in sched.state.values()):
        raise ValueError("save_scheduler called mid-tick (BUSY owners); checkpoint only "
                         "at tick boundaries")
    if set(sched.best_snapshot) != set(sched.trainers):
        raise ValueError("save_scheduler before initial_training: no accepted snapshots")
    draws = _draw_source_state(sched)
    stale = sched._adversary.stale_arrays() if sched._adversary is not None else {}
    meta = dict(metadata or {})
    meta["scheduler"] = {
        "tick": sched._tick,
        "owners": list(sched.trainers),
        "state": {n: s.value for n, s in sched.state.items()},
        "queue": {n: list(q) for n, q in sched.queue.items()},
        "best_score": {n: float(v) for n, v in sched.best_score.items()},
        "epsilons": [float(e) for e in sched.epsilons],
        "accountant": sched.accountant.state_dict(),
        "retries": [[h, c, a] for (h, c), a in sched._retries.items()],
        "peer_failures": dict(sched._peer_failures),
        "deferred": [[r, h, c] for r, h, c in sched._deferred],
        "quarantine_until": dict(sched._quarantine_until),
        "reputation": {n: float(v) for n, v in sched._reputation.items()},
        "adversary_stale": {key: {leaf: list(a.shape) for leaf, a in leaves.items()}
                            for key, leaves in stale.items()},
        "placement": sched._tick_engine.placement.assignments(),
        "rng": {n: tr.rng.bit_generator.state for n, tr in sched.trainers.items()},
        # the streamed pass's frontier is empty at every save point (passes
        # complete whole), so its re-offers live in the queues above
        "stream": {
            "owner_clock": {n: int(v) for n, v in sched._owner_clock.items()},
            "view_version": {n: int(v) for n, v in sched._view_version.items()},
            "owner_free": {n: float(v) for n, v in sched._owner_free.items()},
            "publish_sim": {n: float(v) for n, v in sched._publish_sim.items()},
        },
        # the port's own: the device type the generator states belong to,
        # and the draw source's leaves (shape, dtype)
        "generator_device": sched.device.type,
        "draws_state": {k: [list(a.shape), a.dtype.str] for k, a in draws.items()},
    }
    save_checkpoint(path, _scheduler_tree(sched, draws, stale), metadata=meta)


def restore_scheduler(path: str, sched) -> Dict:
    """Restore a ``FederationScheduler`` built over the same universe with
    the same configuration to a checkpointed tick boundary; returns the
    user metadata. Tables land on the scheduler's device. Raises
    ``ValueError`` for an owner mismatch, a replay cache without a
    configured adversary, a draw-source mismatch, and generator states of
    another device type on a scheduler that draws from its own
    generators."""
    from repro_torch.core.federation import NodeState

    with np.load(path, allow_pickle=False) as z:
        sd = json.loads(str(z["__metadata__"])).get("scheduler")
        if sd is None:
            raise ValueError(f"{path!r} is not a scheduler checkpoint")
        gen_states = {"key": np.array(z["key"])}
        for n in sd["owners"]:
            if f"trainers/{n}/key" in z:
                gen_states[n] = np.array(z[f"trainers/{n}/key"])
    if set(sd["owners"]) != set(sched.trainers):
        raise ValueError(f"checkpoint owners {sorted(sd['owners'])} != scheduler owners "
                         f"{sorted(sched.trainers)}")
    stale_shapes = sd.get("adversary_stale", {})
    if stale_shapes and sched._adversary_for(None) is None:
        raise ValueError("checkpoint carries adversary replay state but no tick_adversary "
                         "is configured on the restoring scheduler")
    draws_state = sd.get("draws_state", {})
    if bool(draws_state) != (sched._draws is not None):
        raise ValueError("checkpoint and scheduler disagree on a draws= source: the "
                         "checkpoint " + ("has" if draws_state else "has none")
                         + ", the scheduler " + ("has one" if sched._draws else "has none"))
    same_device = sd.get("generator_device", sched.device.type) == sched.device.type
    if not same_device and sched._draws is None:
        raise ValueError(
            f"checkpoint holds {sd['generator_device']} generator states, which cannot "
            f"load into this {sched.device.type} scheduler's generators; restore into a "
            "scheduler on the same device type, or draw from a draws= source on both")

    like: Dict[str, Any] = {"trainers": {n: {"params": dict(tr.params)}
                                         for n, tr in sched.trainers.items()}}
    like["adversary"] = {key: {leaf: np.empty(shape, np.float32)
                               for leaf, shape in leaves.items()}
                         for key, leaves in stale_shapes.items()}
    like["draws"] = {k: np.empty(shape, np.dtype(dt)) for k, (shape, dt) in draws_state.items()}
    tree, meta = load_checkpoint(path, like)

    for n, tr in sched.trainers.items():
        params = {k: v.to(sched.device) for k, v in tree["trainers"][n]["params"].items()}
        tr.params = params
        sched.best_snapshot[n] = {k: v.clone() for k, v in params.items()}
        tr.rng.bit_generator.state = sd["rng"][n]
        tr._tri_cache = None
    if same_device:
        sched._ppat_gen.set_state(torch.from_numpy(gen_states["key"]))
        for n, tr in sched.trainers.items():
            tr._gen.set_state(torch.from_numpy(gen_states[n]))
    if sched._draws is not None:
        sched._draws.load_state_dict(
            _unflatten({k: v.numpy() for k, v in _flatten(tree["draws"]).items()}))
    sched._tick = int(sd["tick"])
    sched.state = {n: NodeState(v) for n, v in sd["state"].items()}
    sched.queue = {n: deque(v) for n, v in sd["queue"].items()}
    sched._queued = {n: set(v) for n, v in sd["queue"].items()}
    sched.best_score = {n: float(v) for n, v in sd["best_score"].items()}
    sched.epsilons = [float(e) for e in sd["epsilons"]]
    sched.accountant.load_state_dict(sd["accountant"])
    sched._retries = {(h, c): int(a) for h, c, a in sd["retries"]}
    sched._peer_failures = {k: int(v) for k, v in sd["peer_failures"].items()}
    sched._deferred = [(int(r), h, c) for r, h, c in sd["deferred"]]
    sched._quarantine_until = {k: int(v) for k, v in sd["quarantine_until"].items()}
    sched._reputation = {k: float(v) for k, v in sd.get("reputation", {}).items()}
    st = sd.get("stream", {})
    sched._owner_clock = {k: int(v) for k, v in st.get("owner_clock", {}).items()}
    sched._view_version = {k: int(v) for k, v in st.get("view_version", {}).items()}
    sched._owner_free = {k: float(v) for k, v in st.get("owner_free", {}).items()}
    sched._publish_sim = {k: float(v) for k, v in st.get("publish_sim", {}).items()}
    for owner, version in sched._view_version.items():
        sched._tick_engine.placement.note_version(owner, version)
    if stale_shapes:
        sched._adversary.load_stale(tree["adversary"])
    sched._tick_engine.placement.restore_assignments(sd.get("placement", {}))
    return {k: v for k, v in meta.items() if k != "scheduler"}
