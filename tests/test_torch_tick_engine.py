"""The port's batched tick engine (``core/tick_engine.py``) on the CPU.

Against the JAX package's serial scheduler (``tick_impl="reference"``) from
the same tables and draws (``_torch_parity._pair``): events in every field
of ``EVENT_FIELDS``, queues, states and ledgers exactly, ε bit for bit,
scores within one scoring triple, tables within 1e-5 (``assert_same``).
Against the port's own serial engine from the same draws: every decision,
score, ε and table bit for bit — the batched engine runs the serial path's
functions on its shapes.

The engine's own contracts, as the JAX package's ``tests/test_tick_engine.py``
pins them: programs are reused across ticks, equal-shaped owners share one
program, the plan is a snapshot taken at tick start, a swapped score
function or an accepted extension rebuilds the scoring inputs, a custom
``score_fn`` is scored on the host, the dense ``reference`` training step
is refused before any state moves, a changed learning rate is honoured, and
the three resolvers resolve as the JAX package's.
"""
import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401 (one_torch_thread)
    JaxSchedulerDraws,
    _pair,
    assert_same,
    make_universes,
    one_torch_thread,
)

from repro.kernels import dispatch as jax_dispatch
from repro_torch.core import tick_engine
from repro_torch.core.federation import FederationScheduler, GeneratorDraws, NodeState, TickEntry
from repro_torch.core.ppat import PPATConfig
from repro_torch.kernels import dispatch
from repro_torch.kge.data import equal_shape_universe


@pytest.fixture(scope="module")
def universes():
    return make_universes()


def _fed(kgs, **kw):
    kw = {"dim": 16, "ppat_cfg": PPATConfig(steps=3, seed=0), "local_epochs": 2,
          "update_epochs": 2, "seed": 0, "device": "cpu", "score_max_test": 40, **kw}
    return FederationScheduler(kgs, **kw)


def _key(e):
    return (e.tick, e.host, e.client, e.kind, e.accepted, e.fault, e.attack, e.level,
            e.owner_clock, e.view_version, repr(e.score_before), repr(e.score_after),
            repr(e.epsilon))


def assert_bit_equal(a, b):
    """Two port schedulers took the same decisions with the same scores and
    ε, and hold the same tables, bit for bit."""
    assert list(map(_key, a.events)) == list(map(_key, b.events))
    assert a.epsilons == b.epsilons and a.best_score == b.best_score
    assert {n: list(q) for n, q in a.queue.items()} == {n: list(q) for n, q in b.queue.items()}
    assert a.state == b.state
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k}"


def _serial_twin(universes, j, **kw):
    """The port's serial scheduler on ``j``'s tables and the JAX draws."""
    from repro_torch.kge.models import params_from_numpy

    cfg = PPATConfig(steps=kw.pop("steps", 12), seed=0)
    from repro.core.ppat import PPATConfig as JaxPPATConfig

    jcfg = JaxPPATConfig(steps=cfg.steps, seed=0)
    s = FederationScheduler(universes[1], dim=16, ppat_cfg=cfg, device="cpu",
                            draws=JaxSchedulerDraws(list(universes[1]), 0, jcfg, 16),
                            tick_impl="reference", **kw)
    for n, tr in s.trainers.items():
        tr.params = params_from_numpy(
            {k: np.asarray(v) for k, v in j.trainers[n].params.items()}, "cpu")
    return s


#: (score metric, virtual extension and procrustes refine)
PARITY = [("accuracy", True), ("hit10", True), ("accuracy", False), ("hit10", False)]


@pytest.mark.parametrize("metric,full", PARITY,
                         ids=[f"{m}-{'virtual-refine' if f else 'plain'}" for m, f in PARITY])
def test_batched_equals_both_serial_engines(universes, metric, full):
    """The batched engine against the JAX serial scheduler (within the
    port's parity bounds) and against the port's serial engine (bit for
    bit), held after every tick."""
    kw = dict(local_epochs=2, update_epochs=2, score_metric=metric, steps=6,
              use_virtual=full, procrustes_refine=full)
    j, t = _pair(universes, engine="batched", **kw)
    s = _serial_twin(universes, j, **kw)
    for x in (j, t, s):
        x.initial_training()
    for _ in range(2):
        j.run(max_ticks=1, tick_impl="reference")
        t.run(max_ticks=1)
        s.run(max_ticks=1)
        assert_same(j, t)
        assert_bit_equal(s, t)
    hs = [e for e in t.events if e.kind == "ppat"]
    assert len(hs) == 6 and any(e.accepted for e in hs)
    assert t._tick_engine.stats["entries"] == 6
    assert s._tick_engine.stats["entries"] == 0  # the serial engine never used it


def test_custom_score_fn_is_scored_on_the_host(universes):
    """A ``score_fn`` that is not one of the scheduler's own is opaque to
    the program: it scores the candidate tables on the host, and the
    trajectory is the serial engine's, bit for bit."""
    runs = {}
    for impl in ("reference", "batched"):
        fed = _fed(universes[1], tick_impl=impl)
        fed.score_fn = lambda name, fed=fed: fed._valid_accuracy(name)
        fed.initial_training()
        fed.run(max_ticks=2)
        runs[impl] = fed
    assert runs["batched"]._tick_engine._metric_kind() == "none"
    assert_bit_equal(runs["reference"], runs["batched"])


def test_programs_are_reused_across_ticks(universes):
    """Once every pair and the self-train signatures have run, further ticks
    build no program."""
    fed = _fed(universes[1])
    fed.initial_training()
    fed.run(max_ticks=2)  # each owner has two partners: every pair runs
    for name in fed.trainers:
        fed.queue[name].clear()
        fed._queued[name].clear()
    fed.run(max_ticks=1)  # an all-self-train tick
    n = tick_engine.tick_program_cache_size()
    fed.run(max_ticks=2)
    assert tick_engine.tick_program_cache_size() == n


def test_equal_shaped_owners_share_one_program():
    """Four structurally identical owners: one program for their four
    handshakes, one more for their four self-trains."""
    kgs = equal_shape_universe(4, entities=120, relations=6, triples=800, shared=32, seed=3)
    fed = _fed(kgs, use_virtual=False, score_max_test=24)
    fed.initial_training()
    before = tick_engine.tick_program_cache_size()
    fed.run(max_ticks=1, tick_placement="single")
    assert tick_engine.tick_program_cache_size() == before + 1
    for n in kgs:
        fed.queue[n].clear()
        fed._queued[n].clear()
    fed.run(max_ticks=1, tick_placement="single")
    assert tick_engine.tick_program_cache_size() == before + 2
    assert [e.kind for e in fed.events if e.tick == 2] == ["self-train"] * 4


def test_plan_tick_is_a_snapshot(universes):
    """The plan is fixed at tick start: offers popped, client views frozen
    as copies, idle owners asleep when self-training is off."""
    fed = _fed(universes[1])
    fed.initial_training()
    plan = fed.plan_tick()
    assert all(isinstance(e, TickEntry) for e in plan)
    assert {e.host for e in plan} == set(fed.trainers)
    assert all(e.kind == "ppat" and e.client_view is not None for e in plan)
    for e in plan:
        assert e.client not in fed._queued[e.host]
        live = {v.untyped_storage().data_ptr() for v in fed.trainers[e.client].params.values()}
        assert not any(v.untyped_storage().data_ptr() in live for v in e.client_view.values())
    fed2 = _fed(universes[1])
    fed2.initial_training()
    for n in fed2.trainers:
        fed2.queue[n].clear()
        fed2._queued[n].clear()
    assert fed2.plan_tick(self_train=False) == []
    assert all(s is NodeState.SLEEP for s in fed2.state.values())


def test_score_fn_swap_rebuilds_the_score_cache(universes):
    """Swapping the backtrack metric between runs rebuilds the cached
    scoring inputs as the new metric's."""
    fed = _fed(universes[1])
    fed.initial_training()
    fed.run(max_ticks=1)
    eng = fed._tick_engine
    assert all(eng._score[n]["metric"] == "accuracy" for n in fed.trainers)
    fed.score_fn = fed._valid_hit10
    fed.best_score = {n: fed._valid_hit10(n) for n in fed.trainers}
    fed.run(max_ticks=1)
    evs = [e for e in fed.events if e.tick == fed._tick]
    assert evs and all(0.0 <= e.score_after <= 1.0 for e in evs)
    assert all(eng._score[n]["metric"] == "hit10" and "test" in eng._score[n]["arrays"]
               for n in fed.trainers)


def test_accepted_extension_invalidates_the_score_inputs(universes):
    """An owner whose entity universe grows gets new accuracy negatives
    (drawn against the grown table); stripping it back restores the
    original inputs."""
    fed = _fed(universes[1])
    fed.initial_training()
    name = next(iter(fed.trainers))
    tr = fed.trainers[name]
    e0 = tr.model.num_entities
    info0 = fed._tick_engine._score_info(name)
    neg0 = info0["arrays"]["va_neg"].clone()
    tr.extend_tables(0.01 * torch.ones(3, 16), 0.01 * torch.ones(1, 16),
                     np.array([[e0, tr.model.num_relations, 0]]))
    info1 = fed._tick_engine._score_info(name)
    assert info1 is not info0
    assert not torch.equal(info1["arrays"]["va_neg"], neg0)
    assert int(info1["arrays"]["va_neg"][:, [0, 2]].max()) < e0 + 3
    tr.strip_virtual()
    assert torch.equal(fed._tick_engine._score_info(name)["arrays"]["va_neg"], neg0)


def test_batched_refuses_the_reference_train_step(universes, monkeypatch):
    """The dense host-loop step cannot run in a tick program: the run fails
    before any offer is popped or any draw taken."""
    fed = _fed(universes[1], draws=GeneratorDraws(3, PPATConfig(steps=3, seed=0), 16))
    fed.initial_training()
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "reference")
    queues = {n: list(q) for n, q in fed.queue.items()}
    gen = fed._draws.state_dict()["gen"].clone()
    with pytest.raises(ValueError, match="tick_impl='reference'"):
        fed.run(max_ticks=1, tick_impl="batched")
    assert {n: list(q) for n, q in fed.queue.items()} == queues
    assert torch.equal(fed._draws.state_dict()["gen"], gen)
    assert all(s is NodeState.READY for s in fed.state.values()) and fed._tick == 0
    fed.run(max_ticks=1, tick_impl="reference")  # the serial engine still runs it
    assert [e.tick for e in fed.events][-3:] == [1, 1, 1]


def test_a_changed_learning_rate_is_honoured(universes):
    """``trainer.lr`` changed between runs reaches the retrain: a new
    signature, and the serial engine's tables bit for bit."""
    runs = {}
    for impl in ("reference", "batched"):
        fed = _fed(universes[1], tick_impl=impl)
        fed.initial_training()
        fed.run(max_ticks=1)
        n0 = tick_engine.tick_program_cache_size()
        for tr in fed.trainers.values():
            tr.lr = 0.125
        fed.run(max_ticks=1)
        runs[impl] = (fed, tick_engine.tick_program_cache_size() - n0)
    (ref, _), (bat, grown) = runs["reference"], runs["batched"]
    assert grown >= 1
    assert any(p.spec.lr == 0.125 for p in tick_engine._PROGRAMS.values())
    assert_bit_equal(ref, bat)


def test_an_entry_that_raises_is_isolated(universes, monkeypatch):
    """An uninjected exception inside one entry's program becomes that
    entry's ``error`` event (its host restored, the offer backed off); the
    other entries of the tick land as the serial engine lands them."""
    fed = _fed(universes[1])
    fed.initial_training()
    snap = {k: v.clone() for k, v in fed.best_snapshot["B"].items()}
    segment = tick_engine.TickEngine._segment

    def flaky(self, run, k):  # the plan is A, B, C: B's entry is number 1
        if run.i == 1 and k == len(run.prog.segments) - 1:
            raise RuntimeError("injected")
        return segment(self, run, k)

    monkeypatch.setattr(tick_engine.TickEngine, "_segment", flaky)
    fed.run(max_ticks=1)
    evs = {e.host: e for e in fed.events if e.tick == 1}
    assert evs["B"].fault == "error" and not evs["B"].accepted
    assert evs["A"].fault is None and evs["C"].fault is None
    assert all(torch.equal(fed.trainers["B"].params[k], v) for k, v in snap.items())
    assert fed._retries == {("B", evs["B"].client): 1}
    assert all(s is not NodeState.BUSY for s in fed.state.values())


def test_entry_segments():
    """Where a program is cut for capture: around the procrustes SVD, and
    around the autograd retrain of families the epoch kernel lacks."""
    from repro_torch.kge.models import KGEModel

    def spec(kind, impl, refine=True, score="hit10"):
        return tick_engine.EntrySpec(kind=kind, model=KGEModel("transe", 10, 2, 4), epochs=1,
                                     batch=4, train_impl=impl, renorm="dense", lr=0.5,
                                     cfg=PPATConfig() if kind == "ppat" else None,
                                     aggregation="average", refine=refine, score=score)

    seg = tick_engine.entry_segments
    assert seg(spec("ppat", "fused")) == [
        (("ppat",), True), (("procrustes",), False),
        (("update", "train", "strip", "score"), True)]
    assert seg(spec("ppat", "sparse")) == [
        (("ppat",), True), (("procrustes",), False), (("update",), True),
        (("train",), False), (("strip", "score"), True)]
    assert seg(spec("ppat", "fused", refine=False, score="none")) == [
        (("ppat", "update", "train", "strip"), True)]
    assert seg(spec("self-train", "fused")) == [(("pad", "train", "strip", "score"), True)]
    assert seg(spec("self-train", "sparse")) == [
        (("pad",), True), (("train",), False), (("strip", "score"), True)]


# ------------------------------------------------------------------ resolvers
@pytest.mark.parametrize("env", [None, "reference", "batched"])
@pytest.mark.parametrize("impl", [None, "reference", "batched"])
def test_resolve_tick_impl_equals_the_reference(monkeypatch, impl, env):
    """Explicit beats ``REPRO_TICK_IMPL``; by default ``batched``, unless
    the training step is the dense ``reference`` loop."""
    if env is None:
        monkeypatch.delenv("REPRO_TICK_IMPL", raising=False)
    else:
        monkeypatch.setenv("REPRO_TICK_IMPL", env)
    monkeypatch.delenv("REPRO_TRAIN_IMPL", raising=False)
    assert dispatch.resolve_tick_impl(impl) == jax_dispatch.resolve_tick_impl(impl)
    if env is None:
        assert dispatch.resolve_tick_impl("auto") == "batched"
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "reference")
    assert dispatch.resolve_tick_impl(impl) == jax_dispatch.resolve_tick_impl(impl)


@pytest.mark.parametrize("value,env", [(None, None), ("auto", None), ("single", None),
                                       ("sharded", None), (None, "sharded"),
                                       ("single", "sharded"), (None, "auto")])
def test_resolve_tick_placement_equals_the_reference(monkeypatch, value, env):
    """One device visible to each (no CUDA here, one JAX CPU device): auto
    is ``single`` in both; explicit values and the variable agree."""
    if env is None:
        monkeypatch.delenv("REPRO_TICK_PLACEMENT", raising=False)
    else:
        monkeypatch.setenv("REPRO_TICK_PLACEMENT", env)
    assert dispatch.resolve_tick_placement(value) == jax_dispatch.resolve_tick_placement(value)


@pytest.mark.parametrize("value,env", [(None, None), ("auto", None), ("resident", None),
                                       ("normalize", None), (None, "normalize"),
                                       ("resident", "normalize")])
def test_resolve_tick_residency_equals_the_reference(monkeypatch, value, env):
    if env is None:
        monkeypatch.delenv("REPRO_TICK_RESIDENCY", raising=False)
    else:
        monkeypatch.setenv("REPRO_TICK_RESIDENCY", env)
    assert dispatch.resolve_tick_residency(value) == jax_dispatch.resolve_tick_residency(value)


@pytest.mark.parametrize("knob,bad,match", [
    ("tick_impl", "bogus", "unknown tick impl"),
    ("tick_placement", "everywhere", "unknown tick placement"),
    ("tick_residency", "nowhere", "unknown tick residency"),
    ("aggregation", "sum", "unknown aggregation"),
])
def test_bad_tick_knobs_raise(universes, monkeypatch, knob, bad, match):
    """A bad engine, placement or residency raises ``ValueError`` at
    construction, and at ``run`` from the environment; nothing falls back."""
    base = dict(dim=8, ppat_cfg=PPATConfig(steps=1), device="cpu")
    with pytest.raises(ValueError, match=match):
        FederationScheduler(universes[1], **base, **{knob: bad})
    if knob.startswith("tick_"):
        s = FederationScheduler(universes[1], **base)
        monkeypatch.setenv("REPRO_" + knob.upper(), bad)
        with pytest.raises(ValueError, match=match):
            s.run(max_ticks=1)
        assert s.events == [] and s._tick == 0


def test_the_11kg_example_on_both_engines():
    """``examples/federated_11kg_torch.py``'s scheduler (eleven KGs, mixed
    TransE/H/R/D) at a tiny scale: one tick on the batched engine equals
    the serial engine's bit for bit (one thread: TransR's autograd step is
    not bit-stable run to run on several)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "federated_11kg_torch.py"
    spec = importlib.util.spec_from_file_location("federated_11kg_torch", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cut = dict(scale=4000, dim=16, ppat_steps=3, local_epochs=1, update_epochs=1)
    runs = {}
    for impl in ("reference", "batched"):
        fed = ex.build("cpu", tick_impl=impl,
                       draws=GeneratorDraws(9, PPATConfig(steps=3, seed=0), 16), **cut)
        fed.initial_training()
        fed.run(max_ticks=1)
        runs[impl] = fed
    bat = runs["batched"]
    assert {tr.model.family for tr in bat.trainers.values()} == set(ex.FAMILIES)
    assert bat._tick_engine.last["entries"] == len(bat.trainers) == 11
    assert_bit_equal(runs["reference"], bat)
