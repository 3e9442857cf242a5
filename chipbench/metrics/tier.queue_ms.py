"""Mean queue phase (submit to coalesce) of the requests served in the
window, from their ``tier.request`` spans."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    if not got:
        return None
    _, hi = spans.window(ctx, got)
    return spans.mean_attr([s for s in spans.named(got, "tier.request") if s.end_ns <= hi],
                           "queue_ms")
