"""Host milliseconds a batch in the tier's ``tier.assemble``,
``tier.launch`` and ``tier.collect`` spans begun in the window, less the
collect's ``tier.copy`` (a copy queued behind the batches launched since,
so mostly a wait for the device), over the batches assembled in it."""
from chipbench import spans

HOST = ("tier.assemble", "tier.launch", "tier.collect")


def read(ctx):
    got = spans.recorded()
    if not got:
        return None
    lo, hi = spans.window(ctx, got)
    inside = {i for i, s in enumerate(got) if s.name in HOST and lo <= s.start_ns < hi}
    batches = sum(got[i].name == "tier.assemble" for i in inside)
    copies = sum(s.ms for s in got if s.name == "tier.copy" and s.parent in inside)
    return (sum(got[i].ms for i in inside) - copies) / batches if batches else None
