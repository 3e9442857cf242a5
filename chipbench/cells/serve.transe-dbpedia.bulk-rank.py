"""``serve.transe-dbpedia.bulk-rank``: a rank altered where it is produced."""


def _altered_rank(monkeypatch):
    from repro_torch.kge import eval as kev

    real = kev.fused_ranks
    monkeypatch.setattr(kev, "fused_ranks", lambda *a, **kw: real(*a, **kw) + 1)


FAULTS = [_altered_rank]
CONTROLS = []
SPAN_METRICS = ["tier.queue_ms", "tier.inflight_ms", "tier.host_ms_per_batch"]
