"""Collectives with the gradients a sharded step needs, as autograd
functions over ``torch.distributed`` groups — the transposes the
reference's shard_map derives for its ``all_to_all``, ``psum`` and
``pmean``.

They are the functional collectives (``_functional_collectives``), so the
dry-run's accounting (``utils.collectives.RankAccounting``) sees them and
the fake process group runs them. ``traffic``, where a function takes one,
is a ``core.parties.Traffic`` (or None) that records what this rank hands
to the backend for other ranks and the host seconds spent in the call.

The convention for gradients: every rank back-propagates the same loss, so
the ranks' gradients of a replicated tensor are shares that add up to the
whole.
"""
from __future__ import annotations

import time

import torch
import torch.distributed._functional_collectives as funcol


class _AllToAll(torch.autograd.Function):
    """Equal blocks of dim 0 exchanged over ``group``: block j goes to rank
    j. Its transpose, the backward, is the same exchange."""

    @staticmethod
    def forward(ctx, x, group, traffic):
        ctx.group, ctx.traffic = group, traffic
        return _exchange(x, group, traffic)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.group, ctx.traffic), None, None


def _exchange(x: torch.Tensor, group, traffic) -> torch.Tensor:
    t0 = time.perf_counter()
    out = funcol.wait_tensor(funcol.all_to_all_single(x.contiguous(), None, None, group))
    if traffic is not None:
        n = group.size()
        traffic.seconds += time.perf_counter() - t0
        block = x.numel() // n * x.element_size()
        traffic.note(x[: x.shape[0] // n], n - 1, (n - 1) * block)
    return out


class _SumOver(torch.autograd.Function):
    """The sum over ``group`` of each rank's partial tensor; the backward
    hands each rank the cotangent as it is (every rank holds the same
    loss), as a Megatron row-parallel output does."""

    @staticmethod
    def forward(ctx, x, group, traffic):
        t0 = time.perf_counter()
        out = funcol.wait_tensor(funcol.all_reduce(x, "sum", group))
        if traffic is not None:
            traffic.seconds += time.perf_counter() - t0
            traffic.note(x)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds the same
    copy of; its cotangent, which each rank holds a part of, is summed over
    the group (a Megatron column-parallel input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


class _MeanOver(torch.autograd.Function):
    """The mean over ``groups`` (in turn) of a replicated scalar; the
    backward gives each of the ``world`` ranks its share of the cotangent,
    so the ranks' gradients of a replicated parameter add up to the
    whole."""

    @staticmethod
    def forward(ctx, x, groups, world):
        ctx.world = world
        x = x.view_as(x)
        for g in groups:
            x = funcol.wait_tensor(funcol.all_reduce(x, "sum", g)) / g.size()
        return x

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None, None


def all_to_all(x: torch.Tensor, group, traffic=None) -> torch.Tensor:
    """Equal blocks of ``x``'s dim 0, block j to rank j of ``group``."""
    return _AllToAll.apply(x, group, traffic)


def sum_over(x: torch.Tensor, group, traffic=None) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``group``."""
    return _SumOver.apply(x, group, traffic)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, held the same on every rank of ``group``, as the input of
    per-rank partial work."""
    return _Replicated.apply(x, group)


def mean_over(x: torch.Tensor, groups, world: int) -> torch.Tensor:
    """The mean of a replicated scalar over ``groups`` in turn; ``world``
    ranks back-propagate it. With no groups, a scalar that each of
    ``world`` ranks computed whole, each taking its share of the
    cotangent."""
    return _MeanOver.apply(x, groups, world)
