"""Percent of the window in which no kernel ran while the tier assembled,
launched or collected a batch (``tier.assemble``, ``tier.launch``,
``tier.collect`` spans): the part of ``idle_share.serve`` the tier's host
path explains."""
from chipbench import spans

HOST = ("tier.assemble", "tier.launch", "tier.collect")


def read(ctx):
    got = spans.recorded()
    return got and spans.idle_in(ctx, got, lambda s: s.name in HOST)
