"""``serve.transr-dbpedia.bulk-rank``: the projection broken where the
ranks are produced, and a rank altered."""
import torch


def _wrap(monkeypatch, change):
    from repro_torch.kge import eval as kev

    real = kev.projected_ranks
    monkeypatch.setattr(kev, "projected_ranks", lambda *a, **kw: change(real, *a, **kw))


def _projection_left_out(monkeypatch):
    """Identity matrices in the kernel's place."""
    def change(real, ent, proj, rel, *a, **kw):
        eye = torch.eye(proj.shape[1], device=proj.device).expand_as(proj).contiguous()
        return real(ent, eye, rel, *a, **kw)

    _wrap(monkeypatch, change)


def _next_relations_matrix(monkeypatch):
    """Each group projected by the next relation's matrix."""
    _wrap(monkeypatch, lambda real, ent, proj, rel, *a, **kw:
          real(ent, proj.roll(-1, 0).contiguous(), rel, *a, **kw))


def _altered_rank(monkeypatch):
    _wrap(monkeypatch, lambda real, *a, **kw: real(*a, **kw) + 1)


FAULTS = [_projection_left_out, _next_relations_matrix, _altered_rank]
CONTROLS = ["tf32"]
SPAN_METRICS = ["tier.relations_per_batch", "tier.queue_ms", "tier.inflight_ms",
                "tier.host_ms_per_batch"]
