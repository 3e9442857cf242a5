"""Owner placement in the port (``core/distributed.py``'s ``OwnerPlacement``
and ``chunk_extents``, the batched engine's ``tick_placement="sharded"``)
on the CPU.

``OwnerPlacement`` and ``chunk_extents`` equal the JAX package's on the same
inputs. ``sharded`` over four CPU slots (the device list the engine places
over, patched as the JAX package's tests force host devices) runs every
entry on its slot's device — here all the CPU — so it must take the same
decisions and give the same tables as ``single``, bit for bit; slots stay
where they were first given through plan changes; and a checkpoint keeps
them, so a resumed sharded run equals the uninterrupted one bit for bit.
"""
import numpy as np
import pytest
import torch
from _torch_parity import make_universes, one_torch_thread  # noqa: F401

from repro.core import distributed as jax_distributed
from repro_torch.checkpoint import restore_scheduler, save_scheduler
from repro_torch.core import distributed, tick_engine
from repro_torch.core.federation import FederationScheduler
from repro_torch.core.ppat import PPATConfig
from repro_torch.kge.data import equal_shape_universe

CPU = torch.device("cpu")
SLOTS = 4


@pytest.fixture(scope="module")
def universes():
    return make_universes()


@pytest.fixture
def four_slots(monkeypatch):
    """The engine places over four CPU slots."""
    monkeypatch.setattr(tick_engine, "default_placement_devices", lambda device: [CPU] * SLOTS)


def _fed(kgs, **kw):
    kw = {"dim": 16, "ppat_cfg": PPATConfig(steps=3, seed=0), "local_epochs": 2,
          "update_epochs": 1, "seed": 0, "device": "cpu", "score_max_test": 24, **kw}
    return FederationScheduler(kgs, **kw)


def _key(e):
    return (e.tick, e.host, e.client, e.kind, e.accepted, e.fault, e.level, e.owner_clock,
            e.view_version, repr(e.score_before), repr(e.score_after), repr(e.epsilon))


def _same(a, b):
    assert list(map(_key, a.events)) == list(map(_key, b.events))
    assert a.epsilons == b.epsilons and a.best_score == b.best_score
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k}"


@pytest.mark.parametrize("n_devices", [1, 3, 4])
def test_owner_placement_equals_the_reference(n_devices):
    """Round-robin homes in first-seen order, sticky under later lookups in
    any order, versions noted, checkpointed slots adopted (wrapping)."""
    names = [f"K{i}" for i in range(7)]
    port = distributed.OwnerPlacement([CPU] * n_devices)
    ref = jax_distributed.OwnerPlacement(devices=tuple(f"d{i}" for i in range(n_devices)))
    for order in (names, names[::-1], ["LATE"] + names):
        assert [port.slot(n) for n in order] == [ref.slot(n) for n in order]
    assert port.assignments() == ref.assignments()
    assert port.device("K4") == CPU
    for p in (port, ref):
        p.note_version("K1", 3)
    assert port.version("K1") == ref.version("K1") == 3 and port.version("K2") == 0
    for p in (port, ref):
        p.restore_assignments({"K9": 6, "K0": 1})
    assert port.assignments() == ref.assignments()
    with pytest.raises(ValueError):
        distributed.OwnerPlacement([])


def test_chunk_extents_equal_the_reference():
    for d in (1, 2, 3, 4, 6, 8):
        for n in range(0, 4 * d + 1):
            assert distributed.chunk_extents(n, d) == jax_distributed.chunk_extents(n, d), (n, d)
    with pytest.raises(ValueError):
        distributed.chunk_extents(3, 0)


@pytest.mark.parametrize("universe", ["equal-owners", "distinct-owners"])
def test_sharded_equals_single(universes, four_slots, universe):
    """Four equal owners (one signature group, cut into one chunk over the
    four slots) and three distinct ones (lone entries on their homes): the
    sharded run is the single run, bit for bit."""
    if universe == "equal-owners":
        kgs = equal_shape_universe(4, entities=120, relations=6, triples=800, shared=32, seed=5)
        kw = {"use_virtual": False}
    else:
        kgs, kw = universes[1], {}
    runs = {}
    for placement in ("single", "sharded"):
        s = _fed(kgs, tick_placement=placement, **kw)
        s.initial_training()
        s.run(max_ticks=3)
        runs[placement] = s
    _same(runs["single"], runs["sharded"])
    sharded = runs["sharded"]._tick_engine
    assert sorted(sharded.placement.assignments().values()) == \
        sorted(i % SLOTS for i in range(len(kgs)))
    assert runs["single"]._tick_engine.placement.assignments() == {}


def test_slots_are_sticky_across_plan_changes(four_slots):
    """Handshake ticks, a drained self-train tick, then handshakes again:
    no owner's home moves, and a steady tick uploads no cached input."""
    kgs = equal_shape_universe(4, entities=120, relations=6, triples=900, shared=32, seed=5)
    fed = _fed(kgs, use_virtual=False, tick_placement="sharded")
    fed.initial_training()
    eng = fed._tick_engine
    fed.run(max_ticks=3)
    homes = eng.placement.assignments()
    assert sorted(homes.values()) == [0, 1, 2, 3]
    saved = {n: list(fed.queue[n]) for n in kgs}
    for n in kgs:
        fed.queue[n].clear()
        fed._queued[n].clear()
    fed.run(max_ticks=1)
    assert eng.placement.assignments() == homes
    for n, q in saved.items():
        for c in q:
            if c not in fed._queued[n]:
                fed.queue[n].append(c)
                fed._queued[n].add(c)
    uploads, programs = eng.resident_transfers, tick_engine.tick_program_cache_size()
    fed.run(max_ticks=2)
    assert eng.placement.assignments() == homes
    assert eng.resident_transfers == uploads
    assert tick_engine.tick_program_cache_size() == programs


@pytest.mark.parametrize("residency", ["resident", "normalize"])
def test_checkpoint_keeps_the_placement(universes, four_slots, tmp_path, residency):
    """The sidecar holds the sticky slots; a fresh scheduler that restores
    it homes every owner where the interrupted run did and resumes it bit
    for bit."""
    def make():
        return _fed(universes[1], tick_placement="sharded", tick_residency=residency)

    path = str(tmp_path / "sched.npz")
    a = make()
    a.initial_training()
    a.run(max_ticks=1)
    homes = a._tick_engine.placement.assignments()
    assert homes
    save_scheduler(path, a)
    a.run(max_ticks=2)
    b = make()
    b._tick_engine.placement.slot("C")  # a resumed plan may meet owners in another order
    restore_scheduler(path, b)
    assert b._tick_engine.placement.assignments() == homes
    assert {n: b._tick_engine.placement.version(n) for n in b.trainers} == \
        {n: v for n, v in b._view_version.items()}
    b.run(max_ticks=2)
    tail = [e for e in a.events if e.tick > 1]
    assert tail and list(map(_key, tail)) == list(map(_key, b.events))
    for n in a.trainers:
        for k, v in a.trainers[n].params.items():
            assert torch.equal(v, b.trainers[n].params[k]), f"{n}.{k}"
    assert np.isfinite(b.accountant.epsilon())
