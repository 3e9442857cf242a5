"""Spec rule tables for every parameter, optimizer moment, cache and batch
tensor — the port of the JAX package's ``sharding/specs.py``.

A spec is a tuple with one entry per tensor dimension: a mesh axis name, a
tuple of names (the dimension split over several axes, major to minor), or
``None`` (not split) — what ``jax.sharding.PartitionSpec`` holds. The rules
match on the reference's tree paths, which ``models.model.lm_tree(cfg,
model)`` gives the port's parameters: each layer stack carries a leading
repeat axis, which is never split, and matrices are ``(d_in, d_out)``.
``placements`` turns such a spec into DTensor placements for the port's
own tensor (one module per layer, ``(d_out, d_in)`` weights).

Baseline layout (single pod): mesh ('data', 'model') = (16, 16).
  * embeddings / unembedding: vocab over 'model'
  * attention: head dim of QKV over 'model', wo mirrored
  * dense MLP: d_ff over 'model'
  * MoE experts: expert axis over 'data' (expert parallelism), d_ff over
    'model' — token→expert dispatch becomes all-to-all traffic
  * SSM: channel/head axes over 'model'
  * optimizer moments: same spec as their parameter
Multi-pod adds a leading 'pod' axis composed into the batch axes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Any, ...]

DATA_SIZE = 16  # production mesh 'data' axis extent (per pod)
MODEL_SIZE = 16  # production mesh 'model' axis extent


def _rule(names: Tuple[str, ...], ndim: int, shape: Tuple[int, ...]) -> Spec:
    """A param path + rank/shape → its spec (layer stacks add a leading
    unsplit axis, handled by rank arithmetic)."""
    n = set(names)
    lead = (None,) * (ndim - 2)

    # --- MoE expert weights: (L, E, d, f) / (L, E, f, d) -----------------
    # Expert parallelism (expert axis over 'data') only when the expert count
    # divides the data axis; few-expert cards (Mixtral: 8) replicate the
    # experts but split BOTH matrix dims, so the weights still split 256 ways.
    if "w_gate" in n or "w_up" in n or "w_down" in n:
        e_axis = ndim - 3
        if shape[e_axis] % DATA_SIZE == 0:
            if "w_down" in n:
                return (*((None,) * e_axis), "data", "model", None)
            return (*((None,) * e_axis), "data", None, "model")
        if "w_down" in n:
            return (*((None,) * e_axis), None, "model", "data")
        return (*((None,) * e_axis), None, "data", "model")
    if "shared_gate" in n or "shared_up" in n:
        return (*((None,) * (ndim - 3)), None, None, "model")
    if "shared_down" in n:
        return (*((None,) * (ndim - 3)), None, "model", None)
    if "router" in n:
        return (None,) * ndim

    # --- embeddings --------------------------------------------------------
    if "table" in n:  # (V, d)
        return ("model", None)
    if "pos_emb" in n:
        return (None,) * ndim

    # --- attention ---------------------------------------------------------
    if n & {"wq", "wk", "wv"}:
        if names[-1] == "b":
            return (*((None,) * (ndim - 1)), "model")
        return (*lead, None, "model")
    if "wo" in n:
        if names[-1] == "b":
            return (None,) * ndim
        return (*lead, "model", None)
    if "unembed" in n:
        if names[-1] == "b":
            return (*((None,) * (ndim - 1)), "model")
        return (*lead, None, "model")  # (d, V): vocab over model

    # --- dense MLP ---------------------------------------------------------
    if n & {"up", "gate"}:
        if names[-1] == "b":
            return (*((None,) * (ndim - 1)), "model")
        return (*lead, None, "model")
    if "down" in n:
        if names[-1] == "b":
            return (None,) * ndim
        return (*lead, "model", None)

    # --- SSM ---------------------------------------------------------------
    if "in_proj" in n:
        return (*lead, None, "model")
    if "out_proj" in n:
        return (*lead, "model", None)
    if n & {"conv_w", "conv_b", "norm_scale", "A_log", "D", "dt_bias"}:
        return (*((None,) * (ndim - 1)), "model")

    # --- frontend stubs / norms / everything else: replicated --------------
    return (None,) * ndim


def _check_layout(layout: str) -> None:
    if layout not in ("tp", "dp"):
        raise ValueError(f"unknown layout {layout!r} (tp|dp)")


def map_tree(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists; list entries are
    named ``[i]`` in the path, as ``jax.tree_util.SequenceKey`` prints."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params: Any, *, layout: str = "tp") -> Any:
    """The spec of every leaf of ``params`` (the reference's tree, leaves
    with a ``shape``, as ``lm_tree`` gives them).

    layout="tp" (default): the tensor/expert parallel rules above.
    layout="dp": every parameter replicated — for small cards, where the
    per-layer activation all-reduces of tensor parallelism outweigh pure
    data parallelism's one gradient all-reduce."""
    _check_layout(layout)
    if layout == "dp":
        return map_tree(lambda _, x: (None,) * len(x.shape), params)
    return map_tree(lambda path, x: _rule(path, len(x.shape), tuple(x.shape)), params)


def state_specs(params: Any, *, layout: str = "tp") -> Dict[str, Any]:
    """The train state's specs: the parameters', and the AdamW moments'
    (the same as their parameter's) beside the replicated 0-d step — the
    reference's ``TrainState(params, AdamWState(step, mu, nu))``."""
    pspec = param_specs(params, layout=layout)
    return {"params": pspec, "opt": {"step": (), "mu": pspec, "nu": pspec}}


def batch_spec(multi_pod: bool, *, layout: str = "tp") -> Spec:
    if layout == "dp":  # batch over every mesh axis
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return (axes, None)
    return (("pod", "data") if multi_pod else "data", None)


def _kv_cache_spec(kv_heads: int, batch: int, model_size: int, batch_axes) -> dict:
    """(R, B, T, KV, Dh) cache spec: heads over 'model' when they divide,
    else the sequence; batch over the data axes when batch > 1, else the
    sequence also takes them (long-context decode)."""
    if batch > 1:
        if kv_heads % model_size == 0:
            kv = (None, batch_axes, None, "model", None)
        else:
            kv = (None, batch_axes, "model", None, None)
    else:
        if kv_heads % model_size == 0:
            kv = (None, None, batch_axes, "model", None)
        else:
            axes = ((batch_axes, "model") if not isinstance(batch_axes, tuple)
                    else (*batch_axes, "model"))
            kv = (None, None, axes, None, None)
    return {"k": kv, "v": kv}


def cache_specs(cache: Sequence[dict], cfg, batch: int, *, multi_pod: bool) -> Dict[str, List]:
    """The reference's cache spec tree ``{"layers": [...]}``, one entry per
    dict of ``cache`` (the reference's period positions, or the port's
    layers: the rules read only which parts a layer's cache has)."""
    model_size = MODEL_SIZE
    batch_axes = ("pod", "data") if multi_pod else "data"

    def per_layer_cache(c: dict) -> dict:
        out = {}
        if "kv" in c:
            out["kv"] = _kv_cache_spec(cfg.num_kv_heads, batch, model_size, batch_axes)
        if "ssm" in c:
            h = cfg.ssm.num_heads(cfg.d_model)
            if batch > 1 and h % model_size == 0:
                state = (None, batch_axes, "model", None, None)
            elif h % model_size == 0:
                state = (None, None, "model", None, None)
            else:
                state = (None, batch_axes if batch > 1 else None, None, None, None)
            conv = (None, batch_axes if batch > 1 else None, None, "model")
            out["ssm"] = {"state": state, "conv": conv}
        if "cross_kv" in c:
            spec = ((None, batch_axes if batch > 1 else None, None, "model", None)
                    if cfg.num_kv_heads % model_size == 0
                    else (None, batch_axes if batch > 1 else None, None, None, None))
            out["cross_kv"] = {"k": spec, "v": spec}
        return out

    return {"layers": [per_layer_cache(c) for c in cache]}


def placements(spec: Spec, mesh: DeviceMesh, *, stacked: bool = False,
               transposed: bool = False) -> Tuple:
    """DTensor placements, one per mesh dim, for the port's tensor whose
    reference spec is ``spec``: ``stacked`` drops the leading repeat axis
    (the port keeps one module per layer), ``transposed`` reverses a
    matrix's two dims (the port's ``(d_out, d_in)`` weight). A dim split
    over several mesh axes is split by each in turn, which is JAX's
    major-to-minor order when the axes come in the mesh's order."""
    spec = tuple(spec[1:] if stacked else spec)
    if transposed:
        if len(spec) != 2:
            raise ValueError(f"only a matrix is transposed, got spec {spec}")
        spec = spec[::-1]
    names = mesh.mesh_dim_names
    out: List[Optional[Any]] = [Replicate()] * len(names)
    last = -1
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}, not in the mesh {names}")
            i = names.index(ax)
            if len(axes) > 1 and i < last:
                raise ValueError(f"spec {spec}: axes {axes} are not in the mesh's order {names}")
            last = i
            out[i] = Shard(dim)
        last = -1
    return tuple(out)


def local_shard(t: torch.Tensor, placements: Sequence, mesh_sizes: Sequence[int],
                coordinate: Sequence[int]) -> torch.Tensor:
    """The block of the whole tensor ``t`` that the rank at ``coordinate``
    of a mesh of ``mesh_sizes`` holds under ``placements``: split by each
    mesh dim in turn (``torch.chunk``, as DTensor splits)."""
    for p, n, c in zip(placements, mesh_sizes, coordinate):
        if isinstance(p, Shard):
            t = t.chunk(n, dim=p.dim)[c]
    return t


def param_placements(cfg, model, mesh: DeviceMesh, *, layout: str = "tp") -> Dict[str, Tuple]:
    """Each parameter of ``model`` (a ``CausalLM``, by state-dict key) →
    its DTensor placements on ``mesh``: the rule of its reference path
    (``models.model.reference_leaves``), on the port's own layout."""
    from repro_torch.models.model import reference_leaves

    _check_layout(layout)
    out = {}
    for key, p, path, stacked, transposed in reference_leaves(cfg, model):
        shape = ((1,) if stacked else ()) + tuple(p.T.shape if transposed else p.shape)
        spec = ((None,) * len(shape) if layout == "dp" else _rule(path, len(shape), shape))
        out[key] = placements(spec, mesh, stacked=stacked, transposed=transposed)
    return out
