"""Percent of the window in which no kernel ran while one of the tick's
stages (a ``tick.*`` span other than the root ``tick``) was open: the part
of ``idle_share.tick`` the program's own spans explain."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    return got and spans.idle_in(ctx, got, lambda s: s.name.startswith("tick."))
