"""Mean milliseconds of a tick entry on its stream: the sum over its
segments of the time between the pair of timing events the tick engine
records on the entry's stream around each (``stream_ms`` of each
``tick.entry`` span; on a card only). Not the entry's device time alone:
a pair's first event completes when the stream reaches it, so the sum also
counts the host's launch time inside a segment (under the profiler each
PPAT graph replay blocks the host for tens of milliseconds) and waits
behind the other entry's stream."""
from chipbench import spans


def read(ctx):
    got = spans.recorded()
    return got and spans.mean_attr(spans.named(got, "tick.entry"), "stream_ms")
