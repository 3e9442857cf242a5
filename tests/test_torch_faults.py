"""The port's federation fault layer (``repro_torch.core.faults``) against
the JAX package's ``core/faults.py`` on the same seeds: the same fault for
every ``(tick, host, client)``, the same rows damaged to the same values by
``FaultInjector.corrupt_view``, and the same verdict and message from
``screen_rows``. All of it is numpy on both sides, so everything is
compared bit for bit."""
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro_torch.core import faults as tf

OWNERS = ("A", "B", "Dbpedia", "Yago")
SPECS = ["crash=0.3,straggle=0.2,seed=9,until=5,delay=0.25",
         "crash=0.2,straggle=0.1,drop=0.2,corrupt=0.2,seed=7,rows=3,mode=garbage",
         "corrupt=1.0,seed=3,norm_bound=5", "on"]


def _key(f):
    return None if f is None else (f.kind, f.delay, f.rows, f.mode)


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_draws_equal_the_reference(spec):
    jp, tp = jf.FaultPlan.parse(spec), tf.FaultPlan.parse(spec)
    for field in ("crash", "straggle", "drop", "corrupt", "seed", "until", "delay", "rows",
                  "mode", "norm_bound"):
        assert getattr(tp, field) == getattr(jp, field), field
    got = [_key(tp.draw(t, h, c)) for t in range(1, 13) for h in OWNERS
           for c in (None,) + OWNERS if c != h]
    want = [_key(jp.draw(t, h, c)) for t in range(1, 13) for h in OWNERS
            for c in (None,) + OWNERS if c != h]
    assert got == want
    again = [_key(tp.draw(t, h, c)) for t in range(1, 13) for h in OWNERS
             for c in (None,) + OWNERS if c != h]
    assert got == again  # stateless: the same key draws the same fault
    if tp.until is not None:
        assert all(tp.draw(t, "A", "B") is None for t in range(tp.until + 1, 20))


def test_fault_plan_parse_errors_and_pinned_tables():
    assert tf.FaultPlan.parse("on") == tf.FaultPlan()
    for bad, exc in (("crash=2.0", ValueError), ("bogus=1", ValueError),
                     ("crash", ValueError), ("mode=fire", ValueError)):
        with pytest.raises(exc):
            jf.FaultPlan.parse(bad)
        with pytest.raises(exc):
            tf.FaultPlan.parse(bad)
    table = {(1, "A"): ("drop",), (2, "A"): ("corrupt",), (3, "B"): ("crash",)}
    jp = jf.FaultPlan(table={k: jf.Fault(*v) for k, v in table.items()})
    tp = tf.FaultPlan(table={k: tf.Fault(*v) for k, v in table.items()})
    for t in range(1, 5):
        for h in OWNERS:
            for c in (None, "C"):  # a self-train has no message to drop or corrupt
                assert _key(tp.draw(t, h, c)) == _key(jp.draw(t, h, c))
    js, ts = (m.FaultPlan.slow_owner("B", delay=2.5, ticks=3, first_tick=2) for m in (jf, tf))
    assert [_key(ts.draw(t, "B", "A")) for t in range(6)] == \
        [_key(js.draw(t, "B", "A")) for t in range(6)]


@pytest.mark.parametrize("mode,rows", [("nan", 4), ("garbage", 7), ("nan", 10_000)])
def test_corrupt_view_equals_the_reference(mode, rows):
    rng = np.random.default_rng(5)
    ent = rng.standard_normal((300, 16)).astype(np.float32)
    rel = rng.standard_normal((9, 16)).astype(np.float32)
    plan_kw = dict(seed=11, mode=mode, rows=rows, norm_bound=50.0)
    ji = jf.FaultInjector(jf.FaultPlan(**plan_kw))
    ti = tf.FaultInjector(tf.FaultPlan(**plan_kw))
    fault_j = jf.Fault("corrupt", rows=rows, mode=mode)
    fault_t = tf.Fault("corrupt", rows=rows, mode=mode)
    want = ji.corrupt_view({"ent": ent, "rel": rel}, fault_j, 3, "Dbpedia")
    view = {"ent": torch.from_numpy(ent.copy()), "rel": torch.from_numpy(rel)}
    got = ti.corrupt_view(view, fault_t, 3, "Dbpedia")
    assert got["rel"] is view["rel"] and torch.equal(view["ent"], torch.from_numpy(ent))
    assert got["ent"].dtype == torch.float32 and got["ent"].device == view["ent"].device
    np.testing.assert_array_equal(got["ent"].numpy(), np.asarray(want["ent"]))  # NaN == NaN here
    damaged = ~np.isclose(got["ent"].numpy(), ent, equal_nan=False).all(1)
    assert damaged.sum() == min(rows, len(ent))


def _screen(mod, rows, bound):
    try:
        mod.screen_rows(rows, bound=bound, host="A", client="B", what="client embeddings")
    except mod.CorruptEmbeddingError as e:
        return (e.kind, e.host, e.client, e.detail)
    return None


def test_screen_rows_equals_the_reference():
    rng = np.random.default_rng(6)
    ok = rng.standard_normal((40, 16)).astype(np.float32)
    nan = ok.copy()
    nan[7, 3] = np.nan
    inf = ok.copy()
    inf[0, 0] = -np.inf
    big = ok.copy()
    big[12] *= 1e4
    for rows in (ok, nan, inf, big, ok[:0]):
        for bound in (1e3, 3.0):
            got = _screen(tf, torch.from_numpy(rows), bound)
            assert got == _screen(jf, rows, bound)
    assert _screen(tf, torch.from_numpy(nan), 1e3)[0] == "corrupt"
    assert issubclass(tf.CorruptEmbeddingError, tf.FaultError)


def test_injector_counts_draws():
    spec = "crash=0.3,straggle=0.3,seed=2"
    ji, ti = jf.FaultInjector(jf.FaultPlan.parse(spec)), tf.FaultInjector(tf.FaultPlan.parse(spec))
    for t in range(1, 30):
        assert _key(ti.draw(t, "A", "B")) == _key(ji.draw(t, "A", "B"))
    assert ti.counts == ji.counts and sum(ti.counts.values()) > 0
    assert ti.norm_bound == ji.norm_bound == tf.DEFAULT_NORM_BOUND
