"""The slice as a whole: one PPAT handshake with its KGEmb update, virtual
extension, retrain and backtrack, run through the port's public functions in
the order of the JAX package's ``FederationScheduler.federate_once``, against
that method itself (the serial reference, ``tick_impl="reference"``).

Two KGs of ``synthesize_universe`` at scale 1/400 (Yago as the client,
Dbpedia as the host), trained locally by the JAX scheduler, are carried
across. Every draw of the handshake is carried across too: the PPAT key
becomes the discriminators' init and the per-round draws
(``jax_ppat_init``/``jax_ppat_draws``) and the host trainer's engine key the
retrain's draws (``jax_draws``).

Compared: the vote counts through ε (bit-equal), the accept decision
(equal), and the host tables right after the retrain, within atol 1e-5. The
handshake's floats agree to about 1e-6 (W, the procrustes rotation, the
averaged rows); the retrain's L1 steps move rows by ±lr/B per term, so the
tables stay that close unless a sign or hinge flips (here they differ by
less than 5e-7). The score after the retrain agrees within one valid triple
(1/|valid|): ``best_threshold_accuracy`` thins its candidate thresholds by
position in the sorted unique scores, so a one-ulp score difference can
move the threshold it tries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import jax_draws, jax_ppat_draws, jax_ppat_init

from repro.core import ppat as jp
from repro.core.federation import FederationScheduler
from repro.kge.data import synthesize_universe as jax_universe
from repro.kge.engine import pad_triples as jax_pad_triples
from repro_torch.core import aggregation as tag
from repro_torch.core import alignment as tal
from repro_torch.core import ppat as tp
from repro_torch.kge.data import corrupt_triples, synthesize_universe
from repro_torch.kge.eval import best_threshold_accuracy
from repro_torch.kge.models import params_from_numpy, score_triples
from repro_torch.kge.trainer import KGETrainer

DIM, STEPS, HIDDEN = 16, 12, 16
HOST, CLIENT = "Dbpedia", "Yago"


def valid_accuracy(trainer, kg) -> float:
    """The scheduler's default backtrack score: best-threshold accuracy on
    the valid split against fixed 1:1 negatives (``default_rng(0)``)."""
    va = kg.valid
    neg = corrupt_triples(np.random.default_rng(0), va, trainer.model.num_entities)

    def s(t):
        t = torch.as_tensor(np.asarray(t, np.int64))
        return score_triples(trainer.params, trainer.model, t[:, 0], t[:, 1], t[:, 2]).numpy()

    return best_threshold_accuracy(s(va), s(neg), max_candidates=256)[1]


def _tables(params):
    return {k: np.array(v) for k, v in params.items()}


#: (PPAT key, aggregation, local epochs): two handshakes that the backtrack
#: accepts, and two after longer local training that it rejects (one with an
#: unchanged score, one with a lower one)
CASES = [(42, "average", 2), (7, "average", 2), (3, "replace", 40), (4, "replace", 40)]


@pytest.mark.parametrize("key_seed,aggregation,local_epochs", CASES)
def test_handshake_matches_federate_once(key_seed, aggregation, local_epochs):
    jkgs = jax_universe(seed=0)
    tkgs = synthesize_universe(seed=0)
    jkgs = {n: jkgs[n] for n in (CLIENT, HOST)}
    tkgs = {n: tkgs[n] for n in (CLIENT, HOST)}
    cfg_j = jp.PPATConfig(steps=STEPS, hidden=HIDDEN)
    cfg_t = tp.PPATConfig(steps=STEPS, hidden=HIDDEN)
    sched = FederationScheduler(jkgs, dim=DIM, ppat_cfg=cfg_j, update_epochs=1,
                                aggregation=aggregation, local_epochs=local_epochs,
                                tick_impl="reference", seed=0)
    sched.initial_training()

    # ---- carry the tables and the draws across -------------------------
    trainers = {}
    for i, n in enumerate((CLIENT, HOST)):
        jt = sched.trainers[n]
        tr = KGETrainer(tkgs[n], "transe", dim=DIM, seed=i, margin=2.0, batch_size=100,
                        device="cpu")
        tr.params = params_from_numpy(_tables(jt.params), "cpu")
        trainers[n] = tr
    host, client = trainers[HOST], trainers[CLIENT]
    key = jax.random.PRNGKey(key_seed)
    engine_key = jax.random.split(sched.trainers[HOST]._key)[1]
    before = valid_accuracy(host, tkgs[HOST])
    assert before == sched.best_score[HOST]

    # ---- the reference: federate_once, tables read at scoring time ------
    seen = {}
    default_score = sched.score_fn

    def score_fn(name):
        seen[name] = _tables(sched.trainers[name].params)
        return default_score(name)

    sched.score_fn = score_fn
    ev = sched.federate_once(HOST, CLIENT, key=key)

    # ---- the port, step by step ------------------------------------------
    snapshot = host.snapshot()
    idx_c, idx_h = tal.AlignmentRegistry.from_kgs(tkgs).entities(CLIENT, HOST)
    x = client.get_entity_embeddings(idx_c)
    y = host.get_entity_embeddings(idx_h)
    n_x = x.shape[0]
    draws = tp.PPATDraws(*(torch.as_tensor(a) for a in jax_ppat_draws(key, cfg_j, n_x, n_x)))
    init = tp.host_params_from_numpy(jax_ppat_init(key, DIM, cfg_j), "cpu")
    pc, ph, hist = tp.train_ppat(x, y, cfg_t, init=init, draws=draws)
    synth = pc.generate(tp._pad_rows(x, tp.PPAT_BUCKET))
    refine = tal.procrustes(synth, tp._pad_rows(y, tp.PPAT_BUCKET))
    synth = synth @ refine
    tag.kgemb_update(host, idx_h, synth[:n_x], mode=aggregation)
    ve = tag.virtual_extension(host, client, tkgs[CLIENT], idx_c, idx_h,
                               lambda e: pc.generate(e) @ refine)
    assert ve is not None and ve.n_virtual_ent > 0
    tr = host._train_triples()
    b = min(host.batch_size, len(tr))
    n_pad = jax_pad_triples(jnp.asarray(tr), b).shape[0]
    host.train_epochs(1, impl="sparse", draws=jax_draws(
        engine_key, 1, n_pad, n_pad // b, b, host.model.num_entities))
    host.strip_virtual()
    retrained = _tables(host.params)
    after = valid_accuracy(host, tkgs[HOST])
    accepted = after > before
    if not accepted:
        host.restore(snapshot)

    # ---- held against the reference --------------------------------------
    assert hist["epsilon"] == ev.epsilon
    assert before == ev.score_before and accepted == ev.accepted
    assert accepted == (aggregation == "average")  # both backtrack paths are covered
    assert abs(after - ev.score_after) <= 1 / len(tkgs[HOST].valid)
    assert host.params["ent"].shape == (tkgs[HOST].num_entities, DIM)
    for k, v in seen[HOST].items():
        np.testing.assert_allclose(retrained[k], v, rtol=0, atol=1e-5, err_msg=k)
    final = _tables(sched.trainers[HOST].params)
    for k, v in final.items():
        if accepted:
            np.testing.assert_allclose(host.params[k].numpy(), v, rtol=0, atol=1e-5)
        else:  # restored bit for bit, in both packages
            assert np.array_equal(host.params[k].numpy(), snapshot[k].numpy())
            assert np.array_equal(v, _tables(sched.best_snapshot[HOST])[k])
