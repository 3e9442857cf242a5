"""What a ``--trace 1`` run reads from ``torch.profiler``: every device
kernel of the window with its start and duration, the device's busy time as
the union of those intervals (kernels on several streams overlap, so their
summed durations can exceed the window), and the breakdown the result line
carries; and the set-up's phases on the host clock (``Phases``).
``busy_union`` is the chip smoke test's ``busy_union_us``."""
from __future__ import annotations

import sys
import time
from typing import Dict, List, NamedTuple, Sequence, Tuple


class Kernel(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


def kernels(prof) -> List[Kernel]:
    """The device kernels and copies of a finished profiler window, in start
    order, read from the raw trace (``prof.events()`` builds a Python tree
    of every event first, which takes seconds for a long window)."""
    from torch.autograd import DeviceType

    out = [Kernel(e.name(), int(e.start_ns()), int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA
           and not getattr(e, "is_hidden_event", lambda: False)()]
    out.sort(key=lambda k: k.start_ns)
    return out


def busy_union(ks: Sequence[Kernel]) -> float:
    """Seconds in which some kernel ran."""
    busy, end = 0, None
    for k in ks:
        a, b = k.start_ns, k.start_ns + k.dur_ns
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e9


def seconds_by_name(ks: Sequence[Kernel]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k in ks:
        out[k.name] = out.get(k.name, 0.0) + k.dur_ns / 1e9
    return out


def matching(ks: Sequence[Kernel], fragment: str) -> List[Kernel]:
    """Kernels whose name holds ``fragment``."""
    return [k for k in ks if fragment in k.name]


def idle_gaps(ks: Sequence[Kernel], top: int = 10) -> List[Tuple[str, float]]:
    """The longest gaps in which no kernel ran, each named by the kernel
    that ended it."""
    gaps, end = [], None
    for k in ks:
        if end is not None and k.start_ns > end:
            gaps.append((f"before {k.name[:80]}", (k.start_ns - end) / 1e9))
        end = k.start_ns + k.dur_ns if end is None else max(end, k.start_ns + k.dur_ns)
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def breakdown(ks: Sequence[Kernel], top: int = 10) -> Dict[str, list]:
    ops = sorted(seconds_by_name(ks).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": [list(g) for g in idle_gaps(ks, top)]}


class Phases:
    """Set-up phases on the host clock, each printed to standard error as
    it ends: a span of the benchmark's own around each call into the
    program's set-up."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()

    def end(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        print(f"chipbench: set-up {name} {now - self.t:.3f} s", file=sys.stderr)
        self.t = now
