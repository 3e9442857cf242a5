"""Milliseconds a tick the host waits in the stream synchronisations of
the tick engine (``tick.sync``), averaged over the window's ticks."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    return got and spans.per_root(got, "tick", lambda s: s.name == "tick.sync")
