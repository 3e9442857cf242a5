"""Eager segments a tick in the window, from the tick engine's ``last``
counters summed over the window's ticks."""


def read(ctx):
    c = ctx.counters
    return c["eager_segments"] / c["ticks"] if c.get("ticks") else None
