"""Percent of the rows the tier launched in the window that were padding
(``stats["padded_rows"]`` over rows dispatched plus padding)."""


def read(ctx):
    c = ctx.counters
    launched = c.get("rows_dispatched", 0) + c.get("padded_rows", 0)
    return 100.0 * c["padded_rows"] / launched if launched else None
