"""Host milliseconds a tick in the program's stages other than the sync:
the children of each ``tick`` span but ``tick.sync`` (plan, prepare,
materialize, issue, post), less the graph-replay ``tick.segment`` spans
(``graph``) inside ``tick.issue``, averaged over the window's ticks. Under
the profiler each replay call blocks the host for tens of milliseconds
where it takes under one untraced, so the replays are left out, their
untraced host time with them, and the number describes the untraced tick."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    if not got:
        return None
    stages = spans.per_root(got, "tick", lambda s: s.name != "tick.sync")
    replays = spans.per_root(got, "tick", lambda s: s.name == "tick.segment"
                             and s.attrs.get("graph"), direct=False)
    return stages - replays
