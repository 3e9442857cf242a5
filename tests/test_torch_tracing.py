"""The port's span recorder (``repro_torch.utils.tracing``) and the spans
of the tick engine and the serving tier, on the CPU.

The recorder records only inside a ``torch.profiler`` session, a fresh
buffer each session, with parent links, on the clock of the profiler's own
events. A tier mix under the profiler gives one ``tier.assemble`` span a
batch and one ``tier.request`` span a served request whose four phases sum
to its latency; a scheduler tick gives one ``tick`` span holding its stages
in order and one ``tick.entry`` span an entry.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core.federation import FederationScheduler
from repro_torch.core.ppat import PPATConfig
from repro_torch.kge.data import equal_shape_universe
from repro_torch.kge.models import KGEModel, init_kge
from repro_torch.serving import KGEServingTier
from repro_torch.utils import tracing


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_outside_a_profiler_session():
    assert not tracing.recording()
    sp = tracing.span("outside", k=1)
    with sp as inner:
        inner.set(more=2)
    assert not sp and sp is tracing.span("other")
    tracing.record("outside.recorded", 0.0, 1.0)
    with _session():
        with tracing.span("inside"):
            pass
    with tracing.span("after"):
        tracing.record("after.recorded", 0.0, 1.0)
    assert [s.name for s in tracing.spans()] == ["inside"]


def test_spans_raise_where_the_profiler_hooks_are_missing(monkeypatch):
    monkeypatch.setattr(tracing, "_HOOKED", False)
    with pytest.raises(RuntimeError, match="hooks"):
        tracing.spans()


def test_spans_nest_with_parent_links_and_attributes():
    with _session():
        assert tracing.recording()
        with tracing.span("root", tick=7) as root:
            with tracing.span("child") as child:
                child.set(entry=1)
                with tracing.span("grandchild"):
                    pass
            tracing.record("given", root.start, child.end, rid=3)
        with tracing.span("second root"):
            pass
    got = tracing.spans()
    assert [s.name for s in got] == ["root", "child", "grandchild", "given", "second root"]
    assert [s.parent for s in got] == [None, 0, 1, 0, None]
    assert got[0].attrs == {"tick": 7} and got[1].attrs == {"entry": 1}
    assert got[3].attrs == {"rid": 3}
    assert got[3].start_ns == got[0].start_ns and got[3].end_ns == got[1].end_ns
    for s in got[1:3]:
        parent = got[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_a_span_holds_the_profilers_event_inside_it():
    """The shared clock: a ``record_function`` range the profiler took
    inside a span lies inside the span's converted start and end."""
    with _session() as prof:
        for i in range(5):
            with tracing.span("outer", i=i):
                with record_function(f"probe{i}"):
                    torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    got = tracing.spans()
    assert len(got) == 5
    for s in got:
        e = events[f"probe{s.attrs['i']}"]
        assert s.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= s.end_ns


def test_each_session_reads_only_its_own_spans():
    with _session():
        with tracing.span("first"):
            pass
    assert [s.name for s in tracing.spans()] == ["first"]
    with _session():
        with tracing.span("second"):
            pass
        tracing.record("second.recorded", 0.0, 0.0)
    assert [s.name for s in tracing.spans()] == ["second", "second.recorded"]


@pytest.mark.parametrize("impl", ["batched", "direct"])
def test_tier_request_phases_cover_the_latency(impl):
    """A mix of rank and top-k requests under the profiler: one
    ``tier.assemble`` span a batch the tier counts, one ``tier.launch`` a
    launch, and one ``tier.request`` a served request, whose phases sum to
    its latency and lie in order inside it."""
    e, r, d = 200, 5, 16
    model = KGEModel("transe", e, r, d, norm_ord=1)
    params = init_kge(0, model, device="cpu")
    rng = np.random.default_rng(0)
    known = np.stack([rng.integers(0, e, 300), rng.integers(0, r, 300),
                      rng.integers(0, e, 300)], 1)
    tier = KGEServingTier(params, model, known, device="cpu", block_e=64, max_batch=32,
                          serve_impl=impl)
    batches = tier.stats["batches"]
    reqs = []
    with _session():
        for i in range(24):
            n = 1 + i % 9
            h, rr, t = rng.integers(0, e, n), rng.integers(0, r, n), rng.integers(0, e, n)
            reqs.append(tier.submit_rank(h, rr, t) if i % 3 else tier.submit_topk(h, rr, k=5))
            if i % 4 == 3:
                tier.step()
        tier.run_until_drained()
    got = tracing.spans()
    names = [s.name for s in got]
    assert names.count("tier.assemble") == tier.stats["batches"] - batches
    assert names.count("tier.launch") == names.count("tier.assemble")
    assert names.count("tier.collect") == names.count("tier.assemble")
    collects = {i for i, s in enumerate(got) if s.name == "tier.collect"}
    copies = [s for s in got if s.name == "tier.copy"]
    assert len(copies) == len(collects) and all(s.parent in collects for s in copies)
    seqs = {s.attrs["seq"] for s in got if s.name == "tier.assemble"}
    by_rid = {s.attrs["rid"]: s for s in got if s.name == "tier.request"}
    assert all(q.state == "served" for q in reqs) and set(by_rid) == {q.rid for q in reqs}
    for q in reqs:
        s = by_rid[q.rid]
        phases = [s.attrs[k] for k in ("queue_ms", "host_ms", "inflight_ms", "collect_ms")]
        assert min(phases) >= 0 and s.attrs["seq"] in seqs
        assert sum(phases) == pytest.approx(1e3 * q.latency, rel=1e-9, abs=1e-9)
        assert s.ms == pytest.approx(1e3 * q.latency, abs=1e-3)


def test_a_scheduler_tick_is_one_span_holding_its_stages_in_order():
    kgs = equal_shape_universe(2, entities=120, relations=6, triples=600, shared=32, seed=3)
    fed = FederationScheduler(kgs, dim=16, ppat_cfg=PPATConfig(steps=3, seed=0), local_epochs=1,
                              update_epochs=1, seed=0, device="cpu", score_max_test=24)
    fed.initial_training()
    for n in kgs:
        fed.broadcast(n)
    with _session():
        fed.run(max_ticks=1)
    got = tracing.spans()
    roots = [i for i, s in enumerate(got) if s.name == "tick"]
    assert len(roots) == 1 and got[roots[0]].attrs == {"tick": fed._tick}
    root = got[roots[0]]
    stages = [s for s in got if s.parent == roots[0]]
    assert [s.name for s in stages] == ["tick.plan", "tick.prepare", "tick.materialize",
                                        "tick.issue", "tick.sync", "tick.post"]
    for a, b in zip(stages, stages[1:]):
        assert root.start_ns <= a.start_ns <= a.end_ns <= b.start_ns <= b.end_ns <= root.end_ns
    assert sum(s.ms for s in stages) >= 0.9 * root.ms
    index = {s.name: got.index(s) for s in stages}
    entries = [s for s in got if s.name == "tick.entry"]
    last = fed._tick_engine.last
    assert len(entries) == last["entries"] == 2
    assert all(s.parent == index["tick.post"] for s in entries)
    assert [(s.attrs["host"], s.attrs["accepted"]) for s in entries] == [
        (ev.host, ev.accepted) for ev in fed.events if ev.tick == fed._tick]
    segments = [s for s in got if s.name == "tick.segment"]
    assert segments and all(s.parent == index["tick.issue"] for s in segments)
    assert {s.attrs["entry"] for s in segments} == {0, 1}
    assert all(isinstance(s.attrs["graph"], bool) for s in segments)
    # no stream on the CPU, so no timing events
    assert all(s.attrs["stream_ms"] is None for s in entries)
