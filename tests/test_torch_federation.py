"""The port's ``FederationScheduler`` (Alg. 1 with its fault layer), on
each of its two tick engines, against the JAX package's serial scheduler
(``tick_impl="reference"``, barrier ticks) on the universe of ``tests/test_federation.py`` (``seed=1``,
``scale=1/500``, owners A/B/C).

Both schedulers start from the same tables (the JAX trainers' initial
tables, carried across with ``params_from_numpy``) and draw the same
randomness: the port takes ``draws=JaxSchedulerDraws(...)``, which replays
the JAX scheduler's PPAT key stream and each trainer's engine key stream.

Compared after every tick:

- the events in order — tick, host, client, kind, accepted, fault, level,
  owner_clock, view_version — exactly; ε of each handshake and of the
  lifetime accountant bit for bit (the vote counts are equal);
- the queues, states and failure ledgers (``_retries``, ``_deferred``,
  ``_quarantine_until``, ``_peer_failures``, ``_reputation``) exactly;
- the scores within one scoring triple (1/|valid| for accuracy, 1/(2·n)
  for Hit@10 over n test triples): ``best_threshold_accuracy`` thins its
  candidate thresholds by position, so a one-ulp score moves the threshold
  it tries (see ``test_torch_handshake.py``);
- the tables within atol 1e-5: the two frameworks sum in different orders,
  and the retrains move rows by ±lr/B per term, so the tables stay that
  close (here ~5e-7) unless a hinge flips. A rejected handshake restores
  the snapshot bit for bit in both.
"""
import re

import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401 (one_torch_thread)
    ENGINES,
    JaxSchedulerDraws,
    _pair,
    _score_tol,
    assert_same,
    make_universes,
    one_torch_thread,
)

from repro.core.federation import FederationScheduler as JaxScheduler
from repro.core.ppat import PPATConfig as JaxPPATConfig
from repro.kge.data import synthesize_universe as jax_universe
from repro_torch.core.federation import FederationScheduler, NodeState
from repro_torch.core.ppat import PPATConfig
from repro_torch.kge.models import params_from_numpy
from repro_torch.serving import KGECandidateRanker, KGEServingTier

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def universes():
    return make_universes()


def _bit_equal(params, snap):
    return all(torch.equal(params[k], snap[k]) for k in snap)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("metric", ["accuracy", "hit10"])
def test_run_matches_the_serial_reference(universes, metric, engine):
    j, t = _pair(universes, local_epochs=4, update_epochs=2, score_metric=metric,
                 engine=engine)
    assert t.initial_training() == pytest.approx(j.initial_training(), abs=_score_tol(t, "A"))
    assert_same(j, t)
    for _ in range(2):  # run(max_ticks=2), held after each tick
        j.run(max_ticks=1)
        t.run(max_ticks=1)
        assert_same(j, t)
    hs = [e for e in t.events if e.kind == "ppat"]
    assert len(hs) == 6 and all(np.isfinite(e.epsilon) and e.epsilon > 0 for e in hs)
    assert any(e.accepted for e in hs) and not all(e.accepted for e in hs)
    assert all(s is not NodeState.BUSY for s in t.state.values())
    assert t.sim_makespan() == max(t.sim_times().values()) > 0


def test_eleven_kgs_of_mixed_families_match_the_serial_reference():
    """The 11-KG example's universe (Tab. 2 and 3 at scale 1/4000, TransE,
    TransH, TransR and TransD in turn) for one tick against the JAX serial
    scheduler. At d = 2 every alignment has at least d rows, so each
    procrustes input has full rank and its polar factor is unique."""
    jkgs, tkgs = make_universes(seed=0, stats=None, aligns=None, scale=1 / 4000)
    fams = ("transe", "transh", "transr", "transd")
    families = {n: fams[i % len(fams)] for i, n in enumerate(tkgs)}
    j, t = _pair((jkgs, tkgs), dim=2, steps=3, families=families, local_epochs=1)
    assert {tr.model.family for tr in t.trainers.values()} == set(fams)
    assert len(t.trainers) == 11
    j.initial_training()
    t.initial_training()
    assert_same(j, t)
    j.run(max_ticks=1)
    t.run(max_ticks=1)
    assert_same(j, t)
    assert sum(e.kind == "ppat" for e in t.events) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_rejected_backtrack_restores_bit_for_bit(universes, engine):
    j, t = _pair(universes, steps=3, engine=engine)
    j.initial_training()
    t.initial_training()
    j.score_fn = t.score_fn = lambda name: -1.0  # every backtrack rejects
    snaps = {n: {k: v.clone() for k, v in t.best_snapshot[n].items()} for n in t.trainers}
    j.run(max_ticks=2)
    t.run(max_ticks=2)
    assert_same(j, t)
    later = [e for e in t.events if e.kind != "init"]
    assert len(later) == 6 and not any(e.accepted for e in later)
    for n, tr in t.trainers.items():
        assert _bit_equal(tr.params, snaps[n]), n


@pytest.mark.parametrize("engine", ENGINES)
def test_quiescence_without_self_train(universes, engine):
    """With self-training off and a score that never improves, every owner
    drains its queue and sleeps: run() stops before max_ticks, as in the
    reference."""
    j, t = _pair(universes, steps=2, score_fn=lambda name: 0.0, engine=engine)
    for s in (j, t):
        s.best_score = {n: 1.0 for n in s.trainers}
        s.best_snapshot = {n: s.trainers[n].snapshot() for n in s.trainers}
        for n in s.trainers:
            s.broadcast(n)
        s.run(max_ticks=50, self_train=False)
    assert_same(j, t)
    assert t._tick < 50 and all(not q for q in t.queue.values())
    assert not any(e.accepted for e in t.events)
    j.run(max_ticks=2, self_train=False)
    t.run(max_ticks=2, self_train=False)
    assert_same(j, t)
    assert all(s is NodeState.SLEEP for s in t.state.values())


@pytest.mark.parametrize("case", ["wake", "dedup"])
def test_broadcast(universes, case):
    """Alg. 1 l. 30: a handshake signal also wakes a sleeping partner (not
    the sender); repeated broadcasts leave one offer per partner."""
    j, t = _pair(universes)
    for s in (j, t):
        if case == "wake":
            for n in s.trainers:
                s.state[n] = type(s.state[n]).SLEEP  # each package's own enum
            s.broadcast("A")
        else:
            for _ in range(7):
                for n in s.trainers:
                    s.broadcast(n)
    assert {n: list(q) for n, q in t.queue.items()} == {n: list(q) for n, q in j.queue.items()}
    assert {n: s.value for n, s in t.state.items()} == {n: s.value for n, s in j.state.items()}
    if case == "wake":
        assert t.state["A"] is NodeState.SLEEP
        assert all(t.state[p] is NodeState.READY and list(t.queue[p]) == ["A"]
                   for p in t.registry.partners("A"))
    else:
        for n in t.trainers:
            assert sorted(t.queue[n]) == sorted(set(t.queue[n])) == t.registry.partners(n)
            assert set(t.queue[n]) == t._queued[n]


@pytest.mark.parametrize("engine", ENGINES)
def test_frozen_views_are_copies_under_the_fused_step(universes, monkeypatch, engine):
    """Tick 1 plans A←B, B←A, C←A: A hosts the first handshake and is the
    client of the third. The port's ``fused`` step (and the KGEmb update)
    write tables in place, so C must read the copy of A frozen at plan time:
    no frozen view shares storage with its owner's live tables, and the
    tick equals the reference's (run with its own default step)."""
    j, t = _pair(universes, engine=engine)
    j.initial_training()
    j.run(max_ticks=1)
    monkeypatch.setenv("REPRO_TRAIN_IMPL", "fused")
    t.initial_training()
    shared = []
    plan_tick = t.plan_tick

    def checked_plan(**kw):
        plan = plan_tick(**kw)
        for e in plan:
            if e.client_view is not None:
                live = {v.untyped_storage().data_ptr() for v in t.trainers[e.client].params.values()}
                shared.extend(k for k, v in e.client_view.items()
                              if v.untyped_storage().data_ptr() in live)
        return plan

    t.plan_tick = checked_plan
    t.run(max_ticks=1)
    assert [(e.host, e.client) for e in t.events if e.tick == 1] == \
        [("A", "B"), ("B", "A"), ("C", "A")]
    assert not shared, f"frozen views share storage with live tables: {shared}"
    assert_same(j, t)


#: (FaultPlan kwargs, pinned table, scheduler kwargs, ticks) per fault kind
FAULT_CASES = {
    "crash-backoff": ({}, {(1, "A"): {"kind": "crash"}}, {"backoff_ticks": 2}, 3),
    "corrupt-blames-client": ({}, {(1, "A"): {"kind": "corrupt", "rows": 10_000}},
                              {"retry_budget": 1, "quarantine_ticks": 3}, 2),
    "garbage-rows": ({"norm_bound": 50.0}, {(1, "B"): {"kind": "corrupt", "rows": 3,
                                                       "mode": "garbage"}}, {}, 2),
    "straggle-deferred": ({}, {(1, "A"): {"kind": "straggle", "delay": 1e6}},
                          {"tick_deadline": 1e5}, 2),
    "drop-blames-nobody": ({}, {(1, "A"): {"kind": "drop"}}, {}, 2),
    "seeded-storm": ({"crash": 0.2, "straggle": 0.1, "corrupt": 0.1, "seed": 7, "until": 3,
                      "delay": 1e6}, None, {"tick_deadline": 1e5, "retry_budget": 2}, 3),
}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_faults_match_the_reference(universes, case, engine):
    plan, table, kw, ticks = FAULT_CASES[case]
    j, t = _pair(universes, steps=3, faults=(plan, table), engine=engine, **kw)
    j.initial_training()
    t.initial_training()
    snaps = {n: {k: v.clone() for k, v in t.best_snapshot[n].items()} for n in t.trainers}
    blamed = []  # the peers whose reputation each failure decayed
    entry_failed = t._entry_failed

    def spy(host, client, kind, **kw):
        before = dict(t._reputation)
        entry_failed(host, client, kind, **kw)
        blamed.append({p for p, r in t._reputation.items() if r != before.get(p, 1.0)})

    t._entry_failed = spy
    for tick in range(1, ticks + 1):
        j.run(max_ticks=1)
        t.run(max_ticks=1)
        assert_same(j, t)
        if tick == 1 and table:
            (_, host), = table
            failed = [e for e in t.events if e.fault is not None]
            assert len(failed) == 1 and failed[0].host == host and not failed[0].accepted
            client, kind = failed[0].client, failed[0].fault
            assert [e for e in t.events if e.tick == 1 and e.fault is None]
            assert _bit_equal(t.trainers[host].params, snaps[host])  # restored
            assert t._retries[(host, client)] == 1
            assert t._deferred == [(1 + kw.get("backoff_ticks", 1), host, client)]
            want = {"crash": {host}, "straggle": {host}, "corrupt": {client}, "drop": set()}
            assert blamed == [want[kind]]
            if kind == "straggle":
                assert failed[0].seconds > 1e5  # the simulated delay is counted
            if kw.get("retry_budget") == 1:
                assert t.state[client] is NodeState.QUARANTINED
    if table is None:
        assert len({e.fault for e in t.events if e.fault}) >= 2, "the storm must fire"
    assert t._injector.counts == j._injector.counts


def test_backoff_into_quarantine_and_release(universes):
    """Three blamed failures back the pair off exponentially and quarantine
    the host; a quarantined owner plans nothing and offers from it are
    deferred; the timed release returns it to READY — ledger for ledger
    with the reference."""
    j, t = _pair(universes, steps=3, backoff_ticks=1, retry_budget=3, quarantine_ticks=2)
    j.initial_training()
    t.initial_training()
    for s in (j, t):
        s._tick = 10
        for _ in range(3):
            s._entry_failed("A", "B", "crash")
    assert_same(j, t)
    assert [r for r, _, _ in t._deferred] == [11, 12, 14]
    assert t.state["A"] is NodeState.QUARANTINED and t._quarantine_until == {"A": 12}
    for tick in (11, 12):
        j._tick = t._tick = tick
        pj, pt = j.plan_tick(), t.plan_tick()
        assert [(e.host, e.kind, e.client) for e in pt] == \
            [(e.host, e.kind, e.client) for e in pj]
        assert_same(j, t)
        if tick == 11:
            assert all(e.host != "A" for e in pt)
            assert {(h, c) for _, h, c in t._deferred if c == "A"} == {("B", "A"), ("C", "A")}
    assert t.state["A"] is NodeState.READY and "A" not in t._quarantine_until


@pytest.mark.parametrize("engine", ENGINES)
def test_tier_follows_the_scheduler(universes, engine):
    """``KGEServingTier.for_owner`` on the real port scheduler: version 1 at
    attach, one more for each of the owner's accepts, and requests served
    from the owner's current tables."""
    _, tkgs = universes
    t = FederationScheduler(tkgs, dim=16, ppat_cfg=PPATConfig(steps=3, seed=0), local_epochs=2,
                            update_epochs=2, seed=0, device="cpu", tick_impl=engine)
    t.initial_training()
    tier = KGEServingTier.for_owner(t, "A", device=CPU, block_e=64)
    assert tier.owner == "A" and tier.version == 1
    t.run(max_ticks=3)
    accepts = sum(e.accepted for e in t.events if e.host == "A" and e.kind != "init")
    assert accepts > 0 and tier.version == 1 + accepts
    assert tier.stats["publish_errors"] == 0
    kg = tkgs["A"]
    q = kg.test[:6]
    req = tier.submit_rank(q[:, 0], q[:, 1], q[:, 2])
    tier.run_until_drained()
    known = np.concatenate([kg.train, kg.valid, kg.test])
    want = KGECandidateRanker(t.trainers["A"].params, t.trainers["A"].model, known,
                              block_e=64).rank_tails(q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_array_equal(req.result, want)
    assert req.version == tier.version


#: (knob, accepted value, bad value, the reference's error) — each knob the
#: robustness slice ported, as a constructor argument or an environment
#: variable
ROBUSTNESS_KNOBS = [
    ("tick_adversary", "drift=0.5", "drift=1.5", "attack rate drift"),
    ("robust_agg", "median", "krum", "unknown robust_agg"),
    ("cos_screen", 0.5, 1.5, "cos_screen"),
    ("tick_sync", "stream", "lockstep", "unknown tick sync"),
    ("REPRO_TICK_SYNC", "streamed", "lockstep", "unknown tick sync"),
    ("REPRO_TICK_ADVERSARY", "sybil=1", "bogus=1", "unknown tick_adversary key"),
]


@pytest.mark.parametrize("knob,good,bad,match", ROBUSTNESS_KNOBS, ids=lambda v: str(v))
def test_robustness_knobs_resolve(universes, monkeypatch, knob, good, bad, match):
    """The adversary, the defenses and streaming are accepted where the JAX
    package accepts them, and a bad value raises its ``ValueError``: the
    adversary's spec when a run resolves it, the others at construction."""
    from repro.core.federation import FederationScheduler as JaxScheduler

    jkgs, tkgs = universes
    base = dict(dim=8, ppat_cfg=PPATConfig(steps=1), device="cpu")
    env = knob.startswith("REPRO_")
    kw = {} if env else {knob: good}
    if env:
        monkeypatch.setenv(knob, good)
    s = FederationScheduler(tkgs, **base, **kw)
    s.run(max_ticks=0)  # resolves every knob, runs nothing
    if "adversary" in knob.lower():
        assert s._adversary is not None
    if knob in ("robust_agg", "cos_screen"):
        assert s._defended
    bad_kw = {} if env else {knob: bad}
    if env:
        monkeypatch.setenv(knob, bad)
    for cls, kgs, extra in ((JaxScheduler, jkgs, {"dim": 8}), (FederationScheduler, tkgs, base)):
        with pytest.raises(ValueError, match=match):
            cls(kgs, **extra, **bad_kw).run(max_ticks=1)


def test_quickstart_first_tick_equals_the_reference(capsys):
    """``examples/quickstart_torch.py`` at cut epochs on the CPU prints well
    formed lines whose first-tick decisions are the JAX scheduler's, run the
    same cut way from the same tables and draws. (Its ``main`` is ``build``
    then ``report``; the test sets the tables in between.)"""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    cut = dict(ppat_steps=12, local_epochs=3, update_epochs=2)
    jkgs = jax_universe(**qs.UNIVERSE)
    jcfg = JaxPPATConfig(steps=cut["ppat_steps"], seed=0)
    j = JaxScheduler(jkgs, dim=qs.DIM, ppat_cfg=jcfg, local_epochs=cut["local_epochs"],
                     update_epochs=cut["update_epochs"], seed=0, tick_impl="reference")
    fed = qs.build("cpu", draws=JaxSchedulerDraws(list(jkgs), 0, jcfg, qs.DIM), **cut)
    for n, tr in fed.trainers.items():
        tr.params = params_from_numpy(
            {k: np.asarray(v) for k, v in j.trainers[n].params.items()}, "cpu")
    qs.report(fed, ticks=1)
    out = capsys.readouterr().out
    j.initial_training()
    j.run(max_ticks=1)
    line = re.compile(r"^  PPAT\((\w+)→(\w+)\): (\d\.\d{3}) → (\d\.\d{3}) (✓ kept|✗ backtracked)"
                      r"  \(ε̂=(\d+\.\d)\)$")
    rows = [line.match(s) for s in out.splitlines() if s.startswith("  PPAT(")]
    assert rows and all(rows), out
    assert re.search(r"^Books: \d+ entities, \d+ triples$", out, re.M)
    assert re.search(r"^after federation     : \{", out, re.M)
    want = [(e.client, e.host, e.accepted, f"{e.epsilon:.1f}")
            for e in j.events if e.kind == "ppat"]
    got = [(m[1], m[2], m[5] == "✓ kept", m[6]) for m in rows]
    assert got == want
