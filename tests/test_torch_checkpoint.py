"""``repro_torch.checkpoint``: crash-consistent scheduler resume, held
against the port's own uninterrupted run (bit for bit) and against the JAX
package's checkpoints and resumed runs (its serial scheduler), on the
universe of ``tests/test_adversary.py``.

- a run cut and resumed mid-storm, mid-quarantine or mid-stream takes the
  uninterrupted run's decisions and ends with its tables bit for bit;
- the resumed tail of the reference's own resume test (its storm, cut
  after two ticks) equals the reference's tail: events exactly, ε bit for
  bit, tables within 1e-5 (``_torch_parity.assert_same``);
- the port's sidecar equals the reference's at the same tick on every
  field both write, the scores within one scoring triple;
- a params checkpoint written by either package loads in the other bit
  for bit;
- the guards refuse what cannot resume bit-identically.
"""
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401 (one_torch_thread)
    ENGINES,
    _pair,
    _score_tol,
    assert_same,
    assert_same_events,
    make_universes,
    one_torch_thread,
)

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import restore_scheduler as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.checkpoint import save_scheduler as jax_save_scheduler
from repro_torch.checkpoint import (
    load_checkpoint,
    restore_scheduler,
    save_checkpoint,
    save_scheduler,
)
from repro_torch.core.federation import FederationScheduler, GeneratorDraws, NodeState
from repro_torch.core.ppat import PPATConfig

#: the reference's resume-test storm (``tests/test_adversary.py``)
STORM = dict(tick_adversary="drift=0.4,replay=0.6,seed=2,strength=0.9,frac=0.5",
             robust_agg="median", cos_screen=0.3)
FIELDS = ("tick", "host", "client", "kind", "accepted", "fault", "attack", "level",
          "owner_clock", "view_version", "score_before", "score_after")


@pytest.fixture(scope="module")
def universes():
    return make_universes()


def _fed(kgs, **kw):
    kw = {"dim": 16, "ppat_cfg": PPATConfig(steps=3, seed=0), "local_epochs": 2,
          "update_epochs": 1, "seed": 0, "device": "cpu", **kw}
    return FederationScheduler(kgs, **kw)


def _events(evs):
    return [[getattr(e, f) for f in FIELDS] + [repr(e.epsilon)] for e in evs]


def _assert_resumed(a, b, cut):
    """``b`` (restored at tick ``cut``, then run) equals ``a``'s tail."""
    tail = [e for e in a.events if e.tick > cut]
    assert tail and _events(tail) == _events(b.events)
    assert a.epsilons == b.epsilons and a.accountant.epsilon() == b.accountant.epsilon()
    for ledger in ("best_score", "_reputation", "_retries", "_deferred", "_quarantine_until",
                   "_peer_failures", "_owner_clock", "_view_version", "_tick"):
        assert getattr(a, ledger) == getattr(b, ledger), ledger
    assert {n: list(q) for n, q in a.queue.items()} == {n: list(q) for n, q in b.queue.items()}
    assert {n: s.value for n, s in a.state.items()} == {n: s.value for n, s in b.state.items()}
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k}"


def _cut_and_resume(make, tmp_path, *, first=2, then=2, **run_kw):
    path = str(tmp_path / "sched.npz")
    a = make()
    a.initial_training()
    a.run(max_ticks=first, **run_kw)
    cut = a._tick
    save_scheduler(path, a)
    a.run(max_ticks=then, **run_kw)
    b = make()
    restore_scheduler(path, b)
    assert b._tick == cut
    b.run(max_ticks=then, **run_kw)
    _assert_resumed(a, b, cut)
    return a, b


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("source", ["generators", "generator-draws"])
def test_resume_mid_storm_is_bit_equal(universes, tmp_path, source, engine):
    """Cut after two storm ticks, with the replay cache filled and the
    reputation decayed: the resumed run re-ships the same stale views."""
    kgs = universes[1]

    def make():
        draws = GeneratorDraws(11, PPATConfig(steps=3, seed=0), 16) \
            if source == "generator-draws" else None
        return _fed(kgs, draws=draws, tick_impl=engine, **STORM)

    a, b = _cut_and_resume(make, tmp_path)
    assert a._adversary._stale and sorted(b._adversary._stale) == sorted(a._adversary._stale)
    assert any(e.attack == "replay" for e in b.events)


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_mid_quarantine_is_bit_equal(universes, tmp_path, engine):
    """Cut while a client sits in quarantine with deferred offers and a
    decayed reputation: release, backoff and re-queue resume exactly."""
    from repro_torch.core.faults import Fault, FaultInjector, FaultPlan

    def make():
        return _fed(universes[1], retry_budget=1, quarantine_ticks=3, tick_impl=engine,
                    tick_faults=FaultInjector(
            FaultPlan(table={(1, "A"): Fault("corrupt", rows=10_000)})), **STORM)

    path = str(tmp_path / "q.npz")
    a = make()
    a.initial_training()
    a.run(max_ticks=1)
    assert NodeState.QUARANTINED in a.state.values() and a._deferred and a._reputation
    save_scheduler(path, a)
    a.run(max_ticks=3)
    b = make()
    restore_scheduler(path, b)
    b.run(max_ticks=3)
    _assert_resumed(a, b, 1)
    assert not a._quarantine_until  # the release happened after the cut


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_mid_stream_is_bit_equal(universes, tmp_path, engine):
    """A checkpoint between streamed passes (bound 0 keeps the staleness
    gate firing) restores the clocks and the view versions."""
    a, b = _cut_and_resume(lambda: _fed(universes[1], tick_impl=engine), tmp_path,
                           tick_sync="stream",
                           staleness_bound=0)
    assert any(e.fault == "stale" for e in a.events)
    assert [e.level for e in a.events if e.tick > 2] == [e.level for e in b.events]


@pytest.mark.parametrize("engine", ENGINES)
def test_resumed_tail_matches_the_reference_resume(universes, tmp_path, engine):
    """The reference's ``test_resume_mid_storm_bit_parity`` on its serial
    engine, and the same cut in the port from the reference's draws: the
    two resumed tails agree."""
    j, t = _pair(universes, steps=3, engine=engine, **STORM)
    j.initial_training()
    t.initial_training()
    j.run(max_ticks=2, tick_impl="reference")
    t.run(max_ticks=2)
    assert_same(j, t)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_scheduler(jpath, j)
    save_scheduler(tpath, t)
    j2, t2 = _pair(universes, steps=3, engine=engine, **STORM)
    jax_restore(jpath, j2)
    restore_scheduler(tpath, t2)
    assert sorted(t2._adversary._stale) == sorted(j2._adversary._stale)
    j2.run(max_ticks=2, tick_impl="reference")
    t2.run(max_ticks=2)
    assert_same_events(j2.events, t2.events, t2)
    assert t2.events and t2._reputation == j2._reputation
    assert_same(j2, t2)


def test_sidecar_matches_the_reference(universes, tmp_path):
    """Field by field on the state both packages write, after the same two
    storm ticks."""
    j, t = _pair(universes, steps=3, **STORM)
    for s, kw in ((j, {"tick_impl": "reference"}), (t, {})):
        s.initial_training()
        s.run(max_ticks=2, **kw)
    jax_save_scheduler(str(tmp_path / "j.npz"), j)
    save_scheduler(str(tmp_path / "t.npz"), t)
    side = {}
    for name in ("j", "t"):
        with np.load(tmp_path / f"{name}.npz") as z:
            side[name] = json.loads(str(z["__metadata__"]))["scheduler"]
    js, ts = side["j"], side["t"]
    for f in ("tick", "owners", "state", "queue", "epsilons", "accountant", "retries",
              "peer_failures", "deferred", "quarantine_until", "reputation",
              "adversary_stale", "placement", "rng"):
        assert ts[f] == js[f], f
    for f in ("owner_clock", "view_version"):
        assert ts["stream"][f] == js["stream"][f], f
    assert set(ts["stream"]) == set(js["stream"])
    assert ts["best_score"].keys() == js["best_score"].keys()
    for n, v in js["best_score"].items():
        assert abs(ts["best_score"][n] - v) <= _score_tol(t, n)
    with zipfile.ZipFile(tmp_path / "j.npz") as zj, zipfile.ZipFile(tmp_path / "t.npz") as zt:
        tables = {n for n in zj.namelist() if "/params/" in n or n.startswith("adversary/")}
        assert tables and tables <= set(zt.namelist())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_params_checkpoint_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    tree = {"params": {"ent": rng.normal(size=(37, 16)).astype(np.float32),
                       "rel": rng.normal(size=(5, 16)).astype(np.float32)},
            "step": np.asarray(7, np.int32)}
    path = str(tmp_path / "params.npz")
    meta = {"config": "transe-16", "epoch": 3}
    if writer == "port":
        save_checkpoint(path, {"params": {k: torch.tensor(v) for k, v in tree["params"].items()},
                               "step": torch.tensor(7, dtype=torch.int32)}, metadata=meta)
        got, got_meta = jax_load(path, {"params": {k: jnp.asarray(v)
                                                   for k, v in tree["params"].items()},
                                        "step": jnp.asarray(0, jnp.int32)})
        leaves = {"ent": got["params"]["ent"], "rel": got["params"]["rel"], "step": got["step"]}
    else:
        jax_save(path, {"params": {k: jnp.asarray(v) for k, v in tree["params"].items()},
                        "step": jnp.asarray(7, jnp.int32)}, metadata=meta)
        got, got_meta = load_checkpoint(path, {"params": {k: torch.zeros(v.shape)
                                                          for k, v in tree["params"].items()},
                                               "step": torch.tensor(0, dtype=torch.int32)})
        assert all(torch.is_tensor(v) for v in got["params"].values())
        leaves = {"ent": got["params"]["ent"].numpy(), "rel": got["params"]["rel"].numpy(),
                  "step": got["step"].numpy()}
    assert got_meta == meta
    for k in ("ent", "rel"):
        np.testing.assert_array_equal(np.asarray(leaves[k]), tree["params"][k])
        assert np.asarray(leaves[k]).dtype == np.float32
    assert np.asarray(leaves["step"]).shape == () and int(leaves["step"]) == 7
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"params": {"ent": torch.zeros(3, 16), "rel": torch.zeros(5, 16)},
                               "step": torch.tensor(0)})
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(path, {"other": torch.zeros(1)})


def _rewrite_sidecar(path, **changes):
    with np.load(path) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    meta = json.loads(str(arrays.pop("__metadata__")))
    meta["scheduler"].update(changes)
    with open(path, "wb") as f:
        np.savez(f, __metadata__=json.dumps(meta), **arrays)


class _NoState:
    """A draw source without ``state_dict``: not checkpointable."""

    def __init__(self, inner):
        self.ppat, self.train = inner.ppat, inner.train


@pytest.mark.parametrize("guard", ["busy", "before-init", "owners", "stale-without-adversary",
                                   "source-without-state", "draws-mismatch",
                                   "device-type", "not-a-scheduler"])
def test_guards(universes, tmp_path, guard):
    kgs = universes[1]
    path = str(tmp_path / "g.npz")
    cfg = PPATConfig(steps=3, seed=0)
    if guard == "before-init":
        with pytest.raises(ValueError, match="before initial_training"):
            save_scheduler(path, _fed(kgs))
        return
    if guard == "source-without-state":
        s = _fed(kgs, draws=_NoState(GeneratorDraws(1, cfg, 16)))
        s.initial_training()
        with pytest.raises(ValueError, match="state_dict"):
            save_scheduler(path, s)
        return
    if guard == "not-a-scheduler":
        save_checkpoint(path, {"x": torch.zeros(2)})
        with pytest.raises(ValueError, match="not a scheduler checkpoint"):
            restore_scheduler(path, _fed(kgs))
        return
    s = _fed(kgs, tick_adversary="replay=1.0,seed=2")
    s.initial_training()
    s.run(max_ticks=2)
    assert s._adversary._stale
    if guard == "busy":
        s.state["A"] = NodeState.BUSY
        with pytest.raises(ValueError, match="mid-tick"):
            save_scheduler(path, s)
        return
    save_scheduler(path, s)
    fresh = _fed(kgs, tick_adversary="replay=1.0,seed=2")
    if guard == "owners":
        other = {n: kgs[n] for n in ("A", "B")}
        with pytest.raises(ValueError, match="owners"):
            restore_scheduler(path, _fed(other))
    elif guard == "stale-without-adversary":
        with pytest.raises(ValueError, match="adversary replay state"):
            restore_scheduler(path, _fed(kgs))
    elif guard == "draws-mismatch":
        with pytest.raises(ValueError, match="draws= source"):
            restore_scheduler(path, _fed(kgs, tick_adversary="replay=1.0,seed=2",
                                         draws=GeneratorDraws(1, cfg, 16)))
    else:  # generator states of another device type, no draw source
        _rewrite_sidecar(path, generator_device="cuda")
        with pytest.raises(ValueError, match="cuda generator states"):
            restore_scheduler(path, fresh)
    assert fresh._tick == 0 and fresh.events == []  # nothing was restored
