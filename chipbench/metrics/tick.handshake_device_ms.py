"""Device milliseconds a tick of every kernel but the epoch kernel: PPAT,
Procrustes, the KGEmb update and virtual extension, the backtrack's scoring,
the norm projection and the copies of the handshake."""
from chipbench.counts import sparse_sgd_step


def read(ctx):
    ticks = ctx.counters.get("ticks")
    if not ticks or not ctx.kernels:
        return None
    ns = sum(k.dur_ns for k in ctx.kernels if sparse_sgd_step.KERNEL not in k.name)
    return ns / 1e6 / ticks
