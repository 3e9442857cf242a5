"""Streamed scheduling in the port (``tick_sync="stream"`` on each of its
two tick engines) against the JAX package's serial scheduler (``tick_impl=
"reference"``), and against the port's own barrier, on the universes of
``tests/test_streaming.py`` (owners A/B/C at ``seed=1``, and the solo owner
S at ``seed=2``; scale 1/500, d = 16, 3 PPAT rounds).

Against the reference: events (with ``level`` and ``attack``), queues,
ledgers and reputation exact, ε bit for bit, scores within one scoring
triple, tables within 1e-5 (``_torch_parity.assert_same``). Against the
port's own barrier (default generators): every decision, score, ε and
table bit for bit.
"""
import pytest
import torch
from _torch_parity import (  # noqa: F401 (one_torch_thread)
    ENGINES,
    _pair,
    assert_same,
    make_universes,
    one_torch_thread,
)

from repro.kernels.dispatch import resolve_tick_sync as jax_resolve_tick_sync
from repro_torch.core.federation import FederationScheduler, NodeState
from repro_torch.core.ppat import PPATConfig
from repro_torch.kernels.dispatch import resolve_tick_sync


@pytest.fixture(scope="module")
def universes():
    return make_universes()


@pytest.fixture(scope="module")
def solo():
    return make_universes(seed=2, stats=[("S", 10, 80000, 260000)], aligns=[])[1]


def _fed(kgs, **kw):
    kw = {"dim": 16, "ppat_cfg": PPATConfig(steps=3, seed=0), "local_epochs": 2,
          "update_epochs": 1, "seed": 0, "device": "cpu", **kw}
    return FederationScheduler(kgs, **kw)


def _key(e):
    """Every field but ``level``, ``seconds`` and ``sim_finish``, floats by
    ``repr`` (exact, NaN equal to NaN)."""
    return (e.tick, e.host, e.client or "", e.kind, e.fault or "", e.attack or "", e.accepted,
            e.owner_clock, e.view_version, repr(e.score_before), repr(e.score_after),
            repr(e.epsilon))


def _same_tables(a, b, what):
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k} differs {what}"


@pytest.mark.parametrize("sync,env,want", [
    (None, None, "barrier"), ("auto", None, "barrier"), ("streamed", None, "stream"),
    ("stream", None, "stream"), (None, "stream", "stream"), (None, "", "barrier"),
    ("lockstep", None, ValueError),
])
def test_resolve_tick_sync_equals_the_reference(monkeypatch, sync, env, want):
    if env is not None:
        monkeypatch.setenv("REPRO_TICK_SYNC", env)
    if want is ValueError:
        for fn in (jax_resolve_tick_sync, resolve_tick_sync):
            with pytest.raises(ValueError, match="tick sync"):
                fn(sync)
    else:
        assert resolve_tick_sync(sync) == jax_resolve_tick_sync(sync) == want


def test_staleness_bound_validation(universes):
    with pytest.raises(ValueError, match="staleness_bound"):
        _fed(universes[1], staleness_bound=-1)
    s = _fed(universes[1])
    with pytest.raises(ValueError, match="staleness_bound"):
        s.run(max_ticks=1, tick_sync="stream", staleness_bound=-2)
    assert s._tick == 0 and s.events == []


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("bound", [0, 10_000], ids=["bound0", "bound-large"])
def test_stream_matches_the_serial_reference(universes, bound, engine):
    """Both schedulers stream the same passes: the same levels, stale
    audits and re-offers, the PPAT draws taken in plan order."""
    j, t = _pair(universes, steps=3, engine=engine)
    j.initial_training()
    t.initial_training()
    for _ in range(3):
        j.run(max_ticks=1, tick_impl="reference", tick_sync="stream", staleness_bound=bound)
        t.run(max_ticks=1, tick_sync="stream", staleness_bound=bound)
        assert_same(j, t)
    assert any(e.level > 0 for e in t.events)
    assert any(e.fault == "stale" for e in t.events) == (bound == 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_mixed_storm_matches_the_serial_reference(universes, engine):
    """A fault storm and a drift attack under streaming, with the median
    defense: the per-entry draws hold level by level."""
    j, t = _pair(universes, steps=3, faults=({"crash": 0.2, "straggle": 0.1, "corrupt": 0.1,
                                              "seed": 7, "until": 3, "delay": 1e6}, None),
                 tick_adversary="drift=0.4,seed=9,strength=1.0,frac=0.4", tick_deadline=1e5,
                 robust_agg="median", engine=engine)
    j.initial_training()
    t.initial_training()
    for _ in range(4):
        j.run(max_ticks=1, tick_impl="reference", tick_sync="stream", staleness_bound=10_000)
        t.run(max_ticks=1, tick_sync="stream", staleness_bound=10_000)
        assert_same(j, t)
    assert any(e.fault for e in t.events) and any(e.attack for e in t.events)


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_large_bound_equals_the_barrier(universes, engine):
    """With a bound no pass exceeds, streaming only reorders: the port's
    streamed run takes its barrier run's decisions bit for bit, from its
    own generators; then both switch back to barrier ticks and agree."""
    runs = {}
    for sync in ("barrier", "stream"):
        s = _fed(universes[1], tick_impl=engine)
        s.initial_training()
        s.run(max_ticks=3, tick_sync=sync, staleness_bound=10_000)
        runs[sync] = s
    bar, strm = runs["barrier"], runs["stream"]
    assert all(e.level == 0 for e in bar.events) and any(e.level > 0 for e in strm.events)
    assert not any(e.fault == "stale" for e in strm.events)
    assert sorted(map(_key, bar.events)) == sorted(map(_key, strm.events))
    assert bar.epsilons == strm.epsilons and bar.best_score == strm.best_score
    assert bar._owner_clock == strm._owner_clock and bar._view_version == strm._view_version
    _same_tables(bar, strm, "between barrier and stream")
    for s in (bar, strm):
        s.run(max_ticks=1, tick_sync="barrier")
    assert sorted(map(_key, bar.events)) == sorted(map(_key, strm.events))
    _same_tables(bar, strm, "after switching back to barrier")


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_bound0_serial_plan_is_the_barrier_in_order(solo, engine):
    """One owner plans dependency-serial passes: bound 0 reproduces the
    barrier in order, with no stale event."""
    runs = {}
    for sync in ("barrier", "stream"):
        s = _fed(solo, tick_impl=engine)
        s.initial_training()
        s.run(max_ticks=3, tick_sync=sync, staleness_bound=0)
        runs[sync] = s
    assert not any(e.fault == "stale" for e in runs["stream"].events)
    assert list(map(_key, runs["barrier"].events)) == list(map(_key, runs["stream"].events))
    _same_tables(runs["barrier"], runs["stream"], "on a dependency-serial plan")


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_bound0_fires_stale_and_reoffers(universes, engine):
    """Bound 0 on an aligned mesh: a later-level entry whose client
    accepted earlier in the pass is audited ``stale`` and re-served."""
    s = _fed(universes[1], tick_impl=engine)
    s.initial_training()
    s.run(max_ticks=6, tick_sync="stream", staleness_bound=0)
    stale = [e for e in s.events if e.fault == "stale"]
    assert stale and all(e.kind == "ppat" and not e.accepted for e in stale)
    done = {(e.tick, e.host, e.client) for e in s.events
            if e.kind == "ppat" and e.fault != "stale"}
    for e in stale:
        assert any(h == e.host and c == e.client and tk >= e.tick for tk, h, c in done), e
    assert any(e.accepted and e.kind == "ppat" for e in s.events)
    assert all(st in (NodeState.READY, NodeState.SLEEP) for st in s.state.values())
    assert not s._deferred


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_draws_ppat_inputs_in_plan_order(universes, engine):
    """A streamed pass asks its draw source for every handshake's PPAT
    inputs in plan order before any level trains, skipping entries a fault
    kills before their draw; a barrier tick asks as each entry runs."""
    from repro_torch.core.faults import Fault, FaultInjector, FaultPlan
    from repro_torch.core.federation import GeneratorDraws

    calls = {}
    for sync in ("barrier", "stream"):
        src = GeneratorDraws(5, PPATConfig(steps=3, seed=0), 16)
        log = []
        ppat, train = src.ppat, src.train
        src.ppat = lambda h, c, nx, ny, ppat=ppat, log=log: (log.append(("ppat", h, c)),
                                                             ppat(h, c, nx, ny))[1]
        src.train = lambda o, *a, train=train, log=log: (log.append(("train", o)), train(o, *a))[1]
        s = _fed(universes[1], draws=src, tick_impl=engine,
                 tick_faults=FaultInjector(FaultPlan(table={(1, "B"): Fault("crash")})))
        s.initial_training()
        del log[:]
        s.run(max_ticks=1, tick_sync=sync, staleness_bound=10_000)
        calls[sync] = (log, [(e.host, e.client) for e in s.events if e.tick == 1])
    log, plan = calls["stream"]
    assert plan[0] == ("A", "B") and ("B", "A") in plan
    assert log[:2] == [("ppat", "A", "B"), ("ppat", "C", "A")]  # B←A crashes: no draw
    assert all(k == "train" for k, *_ in log[2:])
    barrier_log, _ = calls["barrier"]
    assert barrier_log[0] == ("ppat", "A", "B") and barrier_log[1] == ("train", "A")
