"""Reductions the per-layer metric readers share. A reader gets the traced
run's context: the window's kernels (``trace.Kernel``), its busy and wall
seconds, the driver's counters, the launch shapes of each counted kernel
(by the name of its module in ``counts/``) and the card's peaks. A reader
that finds nothing to read returns None, and the metric is left out."""
from __future__ import annotations

import importlib
from typing import Optional

from chipbench import trace


def counts(kernel: str):
    return importlib.import_module(f"chipbench.counts.{kernel}")


def least_seconds(ctx, kernel: str) -> float:
    mod = counts(kernel)
    return sum(mod.least_seconds(s, ctx.peaks) for s in ctx.launches.get(kernel, []))


def idle_share(ctx) -> Optional[float]:
    """Percent of the window in which no kernel ran."""
    if not ctx.kernels or ctx.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.busy_s / ctx.window_s)


def roofline(ctx, kernel: str) -> Optional[float]:
    """Percent: the least time of the kernel's launches in the window over
    the device time its kernels took."""
    if not ctx.launches.get(kernel):
        return None
    spent = sum(k.dur_ns for k in trace.matching(ctx.kernels, counts(kernel).KERNEL)) / 1e9
    if spent <= 0:
        return None
    return 100.0 * least_seconds(ctx, kernel) / spent


def mfu(ctx) -> Optional[float]:
    """Percent: the least time of all counted work in the window (every
    launch of a kernel with a module in ``counts/``) at the data-sheet
    peaks, over the window's wall time."""
    if not ctx.kernels or not any(ctx.launches.values()) or ctx.window_s <= 0:
        return None
    return 100.0 * sum(least_seconds(ctx, k) for k in ctx.launches) / ctx.window_s
