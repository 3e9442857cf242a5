"""Rank functions for ``repro_torch.core.parties.run_parties``: the port's
expert-parallel MoE (``models.moe.apply_moe_alltoall``) and a reduced card
on DTensor parameters over a real mesh. A spawned rank imports this module
by name, so it imports neither JAX nor a test module."""
import numpy as np
import torch

from repro_torch.core.parties import Traffic
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.moe import apply_moe_alltoall, expert_placements
from repro_torch.sharding.specs import local_shard
from repro_torch.utils.collectives import RankAccounting


def moe_rank(group, mesh_shape, cfgs, params, x, dtype="float32"):
    """One forward and backward of the layer on this rank for each config of
    ``cfgs``: ``params`` and ``x`` (B, S, d) whole, as numpy; the rank takes
    its shards. The loss is ``sum(y²) + aux``. Returns, per config, the
    rank's y, aux, the gradients of its shards, the drops (``stats``), and
    the traffic and collectives of the forward."""
    mesh = make_host_mesh(*mesh_shape, device_type=group.device.type)
    return [_forward_backward(mesh, mesh_shape, cfg, params, x, dtype, group.device)
            for cfg in cfgs]


def _forward_backward(mesh, mesh_shape, cfg, params, x, dtype, device):
    coord = mesh.get_coordinate()
    dt = getattr(torch, dtype)
    local = {}
    for k, v in params.items():
        full = torch.from_numpy(np.asarray(v, np.float32))
        shard = local_shard(full, expert_placements(k, mesh), mesh_shape, coord)
        want = torch.float32 if k == "router" else dt
        local[k] = shard.to(device, want).requires_grad_()
    xb = local_shard(torch.from_numpy(np.asarray(x, np.float32)),
                     expert_placements("x", mesh), mesh_shape, coord)
    xb = xb.to(device, dt)
    traffic, stats = Traffic(), {}
    with RankAccounting() as acc:
        y, aux = apply_moe_alltoall(local, xb, cfg, mesh, traffic=traffic, stats=stats)
    forward = traffic.snapshot()
    loss = (y.float() ** 2).sum() + aux
    grads = torch.autograd.grad(loss, list(local.values()))
    return {"coord": list(coord), "y": y.detach().float(), "aux": aux.detach(),
            "grads": {k: g.float() for k, g in zip(local, grads)}, "stats": stats,
            "traffic": forward, "collectives": acc.collectives()}


def sharded_lm_rank(group, mesh_shape, cases, batch):
    """Each (config, state dict, ``lm_loss`` options) of ``cases`` as
    DTensors on a real ('data', 'model') mesh of ``mesh_shape``
    (``launch.workloads.sharded_model``, the values loaded shard by shard),
    with the mesh set: the forward's logits, the loss and its gradients
    (``train.lm_loss``), prefill into a sharded cache and one decode step
    — every result gathered whole. ``batch`` holds the tokens, labels,
    frames and patches; a card takes the frames or patches it reads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.workloads import sharded_cache, sharded_model
    from repro_torch.sharding import context as shard_ctx
    from repro_torch.train.loss import lm_loss

    mesh = make_host_mesh(*mesh_shape, device_type=group.device.type)
    coord = mesh.get_coordinate()
    shard_ctx.set_mesh(mesh)
    whole = {k: torch.from_numpy(v) for k, v in batch.items()}
    b, s = whole["tokens"].shape

    def rows(t):
        local = t.chunk(mesh_shape[0])[coord[0]]
        return DTensor.from_local(local, mesh, (Shard(0), Replicate()), run_check=False,
                                  shape=t.shape, stride=t.stride())

    out = []
    for cfg, state, opts in cases:
        model = sharded_model(cfg, mesh, requires_grad=True)
        with torch.no_grad():
            for k, p in model.named_parameters():
                full = torch.from_numpy(state[k]).to(p.dtype)
                p.to_local().copy_(local_shard(full, p.placements, mesh_shape, coord))
        kw = {}
        if cfg.encoder_layers:
            kw["frames"] = rows(whole["frames"])
        if cfg.num_patches:
            kw["patches"] = rows(whole["patches"])
        tokens, labels = rows(whole["tokens"]), rows(whole["labels"])
        res = {}
        with implicit_replication():
            loss, metrics = lm_loss(model, cfg, tokens, labels, **kw, **opts)
            named = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                        materialize_grads=True)
            res["loss"] = loss.full_tensor()
            res["nll"] = metrics["nll"].full_tensor()
            res["grads"] = {k: g.full_tensor() for k, g in zip(named, grads)}
            with torch.no_grad():
                res["logits"] = model(tokens, **kw).full_tensor()
                cache, _ = sharded_cache(cfg, model, mesh, b, 2 * s + cfg.num_patches,
                                         multi_pod=False)
                res["prefill"] = model.prefill(tokens, cache, **kw).full_tensor()
                res["decode"] = model.decode_step(rows(whole["tokens"][:, -1:]), cache,
                                                  s + cfg.num_patches).full_tensor()
        out.append(res)
    shard_ctx.set_mesh(None)
    return out
