"""Distinct relations of the rank batches the tier assembled in the window:
the mean ``groups`` of its ``tier.group`` spans (the host's grouping of a
batch's rows by relation, for a family that projects per relation)."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    if not got:
        return None
    lo, hi = spans.window(ctx, got)
    return spans.mean_attr([s for s in spans.named(got, "tier.group") if lo <= s.start_ns < hi],
                           "groups")
