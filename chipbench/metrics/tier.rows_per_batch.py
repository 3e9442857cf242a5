"""Query rows the tier dispatched in the window over its batches
(``KGEServingTier.stats["batches"]``)."""


def read(ctx):
    c = ctx.counters
    return c["rows_dispatched"] / c["batches"] if c.get("batches") else None
