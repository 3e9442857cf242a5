"""``serve.transe-dbpedia.bulk-topk``: scores altered where they are produced."""
import torch


def _altered_scores(monkeypatch):
    from repro_torch.serving import engine

    real = engine.pairwise_scores

    def bent(q, table, **kw):
        s = real(q, table, **kw)
        return s + 0.5 * (torch.arange(s.shape[1], device=s.device) % 7)

    monkeypatch.setattr(engine, "pairwise_scores", bent)


FAULTS = [_altered_scores]
CONTROLS = []
SPAN_METRICS = ["tier.queue_ms", "tier.inflight_ms", "tier.host_ms_per_batch"]
