"""The port's Byzantine adversary and defenses (``core.adversary``,
``aggregation.robust_rows``, the scheduler's hooks) against the JAX
package's serial scheduler (``tick_impl="reference"``), through each of
the port's two tick engines, on the universe of
``tests/test_adversary.py`` (``seed=1``, ``scale=1/500``, owners A/B/C,
d = 16, 3 PPAT rounds).

Tolerances:

- plan draws, ``parse`` errors and ``tamper_view``: bit-equal (both are
  numpy over the same stateless seeds);
- ``robust_rows`` on identical inputs with a padded tail: ``median``
  bit-equal (sorts, halves and clamps, each rounded once in both);
  ``clip``, ``trimmed`` and ``mean_cos`` within 1e-6 (sums in another
  order);
- scheduler storms: events (with ``attack``), queues, ledgers and
  reputation exact, ε bit for bit, scores within one scoring triple,
  tables within 1e-5 (``_torch_parity.assert_same``).
"""
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401 (one_torch_thread)
    ENGINES,
    _pair,
    assert_same,
    make_universes,
    one_torch_thread,
)

from repro.core import adversary as ja
from repro.core.aggregation import robust_rows as jax_robust_rows
from repro_torch.core import adversary as ta
from repro_torch.core.aggregation import robust_rows

#: the reference's engine-parity storm (``tests/test_adversary.py``)
ADV = "drift=0.5,sybil=0.3,replay=0.2,seed=5,strength=0.9,frac=0.5"
DEFENSES = {"defenses-off": {}, "defenses-on": {"robust_agg": "median", "cos_screen": 0.3}}


@pytest.fixture(scope="module")
def universes():
    return make_universes()


def _attack(a):
    return None if a is None else (a.kind, a.strength, a.evade, a.frac)


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("spec", [
    ADV,
    "drift=0.4,sybil=0.2,peers=B+C,seed=7,until=9,strength=0.8,evade=0.85,frac=0.5",
    "drift=0.4,replay=0.6,seed=2,strength=0.9,frac=0.5",
    "on",
])
def test_plan_draws_equal_the_reference(spec):
    jp, tp = ja.AdversaryPlan.parse(spec), ta.AdversaryPlan.parse(spec)
    assert [getattr(tp, f) for f in ("drift", "sybil", "replay", "peers", "seed", "until",
                                     "strength", "evade", "frac", "bound")] == \
        [getattr(jp, f) for f in ("drift", "sybil", "replay", "peers", "seed", "until",
                                  "strength", "evade", "frac", "bound")]
    for tick in range(1, 30):
        for host, client in (("A", "B"), ("B", "A"), ("C", "A"), ("B", "C"), ("A", None)):
            assert _attack(tp.draw(tick, host, client)) == _attack(jp.draw(tick, host, client))
    assert tp.draw(1, "A", None) is None


@pytest.mark.parametrize("spec", ["drift=1.5", "bogus=1", "drift", "frac=0", "strength=2",
                                  "evade=1.5", "seed=x"])
def test_parse_errors_equal_the_reference(spec):
    with pytest.raises(ValueError) as want:
        ja.AdversaryPlan.parse(spec)
    with pytest.raises(ValueError) as got:
        ta.AdversaryPlan.parse(spec)
    assert str(got.value) == str(want.value)


def test_pinned_table_equals_the_reference():
    jp = ja.AdversaryPlan(table={(2, "A"): ja.Attack("sybil", strength=0.3)})
    tp = ta.AdversaryPlan(table={(2, "A"): ta.Attack("sybil", strength=0.3)})
    for tick in (1, 2, 3):
        assert _attack(tp.draw(tick, "A", "B")) == _attack(jp.draw(tick, "A", "B"))


# -------------------------------------------------------------- tampering
@pytest.mark.parametrize("frac", [0.5, 1.0], ids=["frac-half", "frac-one"])
@pytest.mark.parametrize("kind", ["drift", "sybil", "replay"])
def test_tamper_view_bit_equal(kind, frac):
    """``tamper_view`` on the same view and rows tampers bit for bit as the
    JAX package's, touches only the attacked rows, stays inside the norm
    screen, and never writes the view it was given."""
    rng = np.random.default_rng(0)
    ent = rng.normal(size=(64, 8)).astype(np.float32) * 3
    rel = rng.normal(size=(5, 8)).astype(np.float32)
    rows = np.concatenate([np.arange(40), [3, 7, 63, 99, -1]])  # duplicates, out of range
    spec = f"{kind}=1.0,seed=3,strength=0.8,frac={frac},bound=4.0"
    jadv = ja.Adversary(ja.AdversaryPlan.parse(spec))
    tadv = ta.Adversary(ta.AdversaryPlan.parse(spec))
    jatk, tatk = jadv.draw(2, "A", "B"), tadv.draw(2, "A", "B")
    assert _attack(jatk) == _attack(tatk) and tatk.kind == kind
    tview = {"ent": torch.tensor(ent), "rel": torch.tensor(rel)}
    keep = {k: v.clone() for k, v in tview.items()}
    views = [({"ent": jnp.asarray(ent), "rel": jnp.asarray(rel)}, dict(tview))]
    if kind == "replay":  # a second, fresh view: the replay ships the first one
        e2 = ent + 1.0
        views.append(({"ent": jnp.asarray(e2), "rel": jnp.asarray(rel)},
                      {"ent": torch.tensor(e2), "rel": torch.tensor(rel)}))
    for tick, (jv, tv) in enumerate(views, start=2):
        want = jadv.tamper_view(jv, jatk, tick, "A", "B", rows=rows)
        got = tadv.tamper_view(tv, tatk, tick, "A", "B", rows=rows)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k, v in keep.items():
        assert torch.equal(tview[k], v), "tamper_view wrote the view it was given"
    if kind == "replay":
        assert list(tadv.stale_arrays()) == list(jadv.stale_arrays()) == ["B::A"]
        np.testing.assert_array_equal(tadv.stale_arrays()["B::A"]["ent"], ent)
    else:
        out = got["ent"].numpy()
        changed = np.where(np.any(out != ent, axis=1))[0]
        targets = set(range(40)) | {63}  # the unique in-range rows
        assert len(changed) == int(np.ceil(frac * 41)) and set(changed) <= targets
        assert np.isfinite(out).all()
        assert (np.linalg.norm(out[changed], axis=1) <= 0.9 * 4.0 + 1e-5).all()
        assert got["rel"] is tview["rel"]


def test_replay_cache_round_trips():
    plan = ta.AdversaryPlan.parse("replay=1.0,seed=1")
    adv = ta.Adversary(plan)
    atk = ta.Attack("replay")
    adv.tamper_view({"ent": torch.ones(4, 3)}, atk, 1, "A", "B", rows=np.arange(4))
    adv2 = ta.Adversary(plan)
    adv2.load_stale(adv.stale_arrays())
    out = adv2.tamper_view({"ent": torch.full((4, 3), 9.0)}, atk, 3, "A", "B", rows=np.arange(4))
    assert torch.equal(out["ent"], torch.ones(4, 3))


# ------------------------------------------------------- robust aggregation
@pytest.mark.parametrize("n,pad,d", [(20, 32, 8), (123, 192, 100), (1, 64, 16)])
@pytest.mark.parametrize("mode", ["none", "clip", "median", "trimmed"])
def test_robust_rows_equal_the_reference(mode, n, pad, d):
    rng = np.random.default_rng(n)
    cur = rng.normal(size=(pad, d)).astype(np.float32)
    synth = (cur + 0.05 * rng.normal(size=(pad, d))).astype(np.float32)
    synth[3 % n] += 50.0  # one Byzantine row
    want, wcos = jax_robust_rows(jnp.asarray(cur), jnp.asarray(synth), jnp.int32(n),
                                 mode=mode, want_cos=True)
    got, gcos = robust_rows(torch.tensor(cur), torch.tensor(synth), n, mode=mode, want_cos=True)
    want, got = np.asarray(want), got.numpy()
    if mode in ("none", "median"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[n:], synth[n:])  # the padded tail passes through
    assert abs(float(gcos) - float(wcos)) <= 1e-6
    _, one = robust_rows(torch.tensor(cur), torch.tensor(synth), n, mode=mode, want_cos=False)
    assert float(one) == 1.0
    if mode != "none" and n > 3:
        assert np.linalg.norm(got[3] - cur[3]) < 5.0  # the outlier is clamped


def test_robust_rows_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown robust_agg"):
        robust_rows(torch.zeros(4, 2), torch.zeros(4, 2), 2, mode="krum", want_cos=False)


# ----------------------------------------------------------- scheduler storms
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("defense", list(DEFENSES))
def test_storm_matches_the_serial_reference(universes, defense, engine):
    """The reference's engine-parity storm through both serial schedulers,
    held after every tick; the replay caches hold the same views."""
    j, t = _pair(universes, steps=3, tick_adversary=ADV, engine=engine, **DEFENSES[defense])
    j.initial_training()
    t.initial_training()
    for _ in range(3):
        j.run(max_ticks=1, tick_impl="reference")
        t.run(max_ticks=1)
        assert_same(j, t)
    attacks = [e.attack for e in t.events if e.attack]
    assert len(set(attacks)) >= 2, f"want several kinds, saw {set(attacks)}"
    assert t._adversary.counts == j._adversary.counts
    js, ts = j._adversary.stale_arrays(), t._adversary.stale_arrays()
    assert list(ts) == list(js)
    assert ts or defense == "defenses-on"  # the defended queue order draws no replay here
    for key in js:
        for leaf in js[key]:
            np.testing.assert_allclose(ts[key][leaf], js[key][leaf], rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_poisoning_storm_flags_and_blames_the_sender(universes, engine):
    """A full-strength drift storm against armed defenses: poison verdicts
    fire on attacked entries only, blame the sending client, and decay its
    reputation — tick for tick with the reference."""
    j, t = _pair(universes, steps=3, tick_adversary="drift=1.0,seed=9,strength=1.0,frac=0.4",
                 robust_agg="median", cos_screen=0.5, engine=engine)
    j.initial_training()
    t.initial_training()
    for _ in range(4):
        j.run(max_ticks=1, tick_impl="reference")
        t.run(max_ticks=1)
        assert_same(j, t)
    poisons = [e for e in t.events if e.fault == "poison"]
    assert poisons and all(e.attack for e in poisons)
    assert t._reputation and set(t._reputation) <= {e.client for e in poisons}


@pytest.mark.parametrize("engine", ENGINES)
def test_inert_adversary_is_bit_identical(universes, engine):
    """``tick_adversary="on"`` changes no decision and no bit of any table."""
    from repro_torch.core.federation import FederationScheduler
    from repro_torch.core.ppat import PPATConfig

    runs = []
    for adv in (None, "on"):
        s = FederationScheduler(universes[1], dim=16, ppat_cfg=PPATConfig(steps=3, seed=0),
                                local_epochs=2, update_epochs=1, seed=0, device="cpu",
                                tick_adversary=adv, tick_impl=engine)
        s.initial_training()
        s.run(max_ticks=2)
        runs.append(s)
    off, on = runs
    assert on._adversary is not None and off._adversary is None
    fields = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
              "owner_clock", "view_version", "score_before", "score_after")
    assert [[getattr(e, f) for f in fields] + [repr(e.epsilon)] for e in on.events] == \
        [[getattr(e, f) for f in fields] + [repr(e.epsilon)] for e in off.events]
    for n in off.trainers:
        for k, v in off.trainers[n].params.items():
            assert torch.equal(on.trainers[n].params[k], v), f"{n}.{k}"


# ------------------------------------------------- reputation + acceptance
@pytest.mark.parametrize("kind", ["crash", "straggle", "drop", "corrupt", "poison"])
def test_blame_map_equals_the_reference(universes, kind):
    """Each failure kind decays the same peer's reputation as the reference:
    the host for crash and straggle, nobody for drop, the sending client for
    corrupt and poison."""
    j, t = _pair(universes, steps=1, robust_agg="median")
    for s in (j, t):
        s._entry_failed("A", "B", kind, emit=False)
    assert t._reputation == j._reputation
    assert t._peer_failures == j._peer_failures
    assert set(t._reputation) == {"crash": {"A"}, "straggle": {"A"}, "drop": set(),
                                  "corrupt": {"B"}, "poison": {"B"}}[kind]


def test_reputation_decay_recovery_and_screen_sharpening(universes):
    j, t = _pair(universes, steps=1, robust_agg="median", cos_screen=0.4, rep_decay=0.5,
                 rep_recover=0.25)
    assert t._defended and t._cos_tau("B") == j._cos_tau("B") == pytest.approx(0.4)
    steps = [("fail", "A", "B"), ("fail", "A", "B"), ("recover", "A", "B"),
             ("recover", "B"), ("recover", "B")]
    taus = []
    for op, *who in steps:
        for s in (j, t):
            if op == "fail":
                s._entry_failed(who[0], who[1], "poison", emit=False)
            else:
                s._rep_recover(*who)
        assert t._reputation == j._reputation
        assert t._cos_tau("B") == j._cos_tau("B")
        taus.append(t._cos_tau("B"))
    assert taus[0] == pytest.approx(1.0 - 0.5 * 0.6) and taus[1] == pytest.approx(1.0 - 0.25 * 0.6)
    assert "A" not in t._reputation and "B" not in t._reputation
    assert taus[-1] == pytest.approx(0.4)
    off = _pair(universes, steps=1)[1]
    assert not off._defended and off._cos_tau("B") == -1.0


@pytest.mark.parametrize("defended", [True, False], ids=["defended", "undefended"])
def test_reputation_priority_order(universes, defended):
    """Defended, the best-reputed queued client is served first (FIFO among
    ties) and a quarantined one is deferred; undefended the queue is FIFO —
    offer for offer with the reference."""
    kw = {"robust_agg": "median"} if defended else {}
    j, t = _pair(universes, steps=1, **kw)
    got = {}
    for name, s in (("jax", j), ("port", t)):
        s._reputation = {"B": 0.2, "C": 0.5}
        s.queue["A"] = deque(["B", "C"])
        s._queued["A"] = {"B", "C"}
        s.queue["B"] = deque(["C", "A"])
        s._queued["B"] = {"C", "A"}
        s.state["A"] = type(s.state["A"]).QUARANTINED
        s._quarantine_until["A"] = 5
        got[name] = ([s._next_offer("A"), s._next_offer("A"), s._next_offer("A")],
                     [s._next_offer("B"), s._next_offer("B")], list(s._deferred))
    assert got["port"] == got["jax"]
    assert got["port"][0] == (["C", "B", None] if defended else ["B", "C", None])
