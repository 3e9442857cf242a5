"""Reductions over the program's own spans that the span readers share.

The port records spans of its host work while a profiler session is active
(``repro_torch.utils.tracing``), on the clock of the trace's kernels. A
``--trace 1`` run's window is that session, so a reader takes the newest
session's spans. Where the port has no recorder, or recorded nothing, a
reader returns None and the metric is left out.

The window is cut to ``ctx.window_s`` from the first span's start: the
driver's window starts just before its first call into the program, and
what the program does after the window (the serving loop's drain) is left
out, as the end-to-end metrics leave it out.
"""
from __future__ import annotations

from statistics import fmean
from typing import Callable, List, Optional, Sequence, Tuple


def recorded() -> Optional[list]:
    """The spans of the traced window, or None."""
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    got = tracing.spans()
    return got or None


def window(ctx, got: Sequence) -> Tuple[int, int]:
    lo = min(s.start_ns for s in got)
    return lo, lo + int(ctx.window_s * 1e9)


def named(got: Sequence, name: str) -> list:
    return [s for s in got if s.name == name]


def mean_attr(spans: Sequence, key: str) -> Optional[float]:
    vals = [s.attrs[key] for s in spans if s.attrs.get(key) is not None]
    return fmean(vals) if vals else None


def per_root(got: Sequence, root: str, child: Callable, direct: bool = True) -> Optional[float]:
    """Mean over the spans named ``root`` of the milliseconds of their
    direct children (with ``direct=False``, of every span below them) for
    which ``child(span)`` holds."""
    roots = {i: 0.0 for i, s in enumerate(got) if s.name == root}
    if not roots:
        return None
    for s in got:
        if not child(s):
            continue
        p = s.parent
        while not direct and p is not None and p not in roots:
            p = got[p].parent
        if p in roots:
            roots[p] += s.ms
    return fmean(roots.values())


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Nanoseconds in both of two disjoint, sorted interval lists."""
    total = i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(ctx, got: Sequence, keep: Callable) -> Optional[float]:
    """Percent of the window in which no kernel ran and a span for which
    ``keep(span)`` holds was open."""
    if not ctx.kernels or ctx.window_s <= 0:
        return None
    lo, hi = window(ctx, got)
    open_ = _union((max(s.start_ns, lo), min(s.end_ns, hi)) for s in got
                   if keep(s) and s.end_ns > lo and s.start_ns < hi)
    busy = _union((k.start_ns, k.start_ns + k.dur_ns) for k in ctx.kernels)
    spent = sum(b - a for a, b in open_) - _overlap(open_, busy)
    return 100.0 * spent / (ctx.window_s * 1e9)
