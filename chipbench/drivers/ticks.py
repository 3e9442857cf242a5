"""Federation rounds: Alg. 1's handshake ticks through ``FederationScheduler``
with the batched tick engine.

Set-up makes the owners, their alignment and their initial tables from the
seed, runs ``initial_training`` and the first tick, which captures each entry
signature's graphs. Before every tick every owner broadcasts, so each tick
plans one PPAT handshake per owner (each hosting the other's frozen view);
the window calls ``run(max_ticks=1)`` tick after tick and only replays. All
draws (the handshakes' discriminators, batches and vote noise, every
epoch's permutation and corruptions) come from a draw source of the
benchmark, keyed by tick, host and client, so the reference draws the same.

``check`` holds against the plain reference: the initial training (each
owner's change of tables and initial score) from the benchmark's tables, and
the set-up tick and the first window tick entry by entry, each from the
program's tables at the tick's start (the reference cannot follow the
program's accept decisions at near ties, so it starts each tick where the
program did). Every checked entry, accepted or restored, is held by its ε,
its backtrack score after the retrain against the score of the reference's
retrain, and its accept decision; an accepted entry also by the host's
change of tables (the scheduler hands out only accepted tables).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from chipbench import gen, trace
from chipbench.counts import sparse_sgd_step
from chipbench.reference import fkge
from chipbench.reference import kge as ref

CHECKED_TICKS = (1, 2)  # the set-up tick and the first window tick


class State:
    pass


def _ppat_draws(cell, tick, host, client, n):
    p = cell.cfg["scheduler"]["ppat"]
    g = gen.generator(cell.device, cell.seed, "ppat", tick, host, client)
    return gen.ppat_draws(g, p["steps"], p["batch"], p["num_teachers"], p["hidden"],
                          cell.cfg["dim"], n)


def _train_draws(cell, tick, owner, epoch, n_pad, nb, batch, n_ent):
    g = gen.generator(cell.device, cell.seed, "train", tick, owner, epoch, n_pad, n_ent)
    return gen.epoch_draws(g, n_pad, nb, batch, n_ent)


class Draws:
    """The scheduler's draw source (``FederationScheduler(draws=...)``)."""

    def __init__(self, st):
        self.st = st

    def ppat(self, host, client, n_x, n_y):
        from repro_torch.core.ppat import PPATDraws

        d = _ppat_draws(self.st.cell, self.st.tick, host, client, n_x)
        init = {"teachers": d["teachers"], "student": d["student"],
                "teachers_vel": {k: torch.zeros_like(v) for k, v in d["teachers"].items()},
                "student_vel": {k: torch.zeros_like(v) for k, v in d["student"].items()}}
        return init, PPATDraws(d["idx"], d["ridx"], d["noise"])

    def train(self, owner, epochs, n_pad, nb, batch, num_entities):
        self.st.epochs.append((self.st.tick, owner, n_pad, nb, batch, num_entities))
        return [_train_draws(self.st.cell, self.st.tick, owner, e, n_pad, nb, batch, num_entities)
                for e in range(epochs)]


def universe(cell):
    """The owners' splits and the aligned id pairs, from the seed."""
    cfg, dev = cell.cfg, cell.device
    splits = {n: gen.owner_split(dev, cell.seed, n, dict(s, eval=cfg["eval_triples"]))
              for n, s in cfg["owners"].items()}
    a, b = cfg["aligned"]["pair"]
    ia, ib = gen.alignment(dev, cell.seed, cfg["owners"][a]["entities"],
                           cfg["owners"][b]["entities"], cfg["aligned"]["entities"])
    return splits, {(a, b): (ia, ib), (b, a): (ib, ia)}


def _clone(sched):
    return {n: {k: v.clone() for k, v in tr.params.items()} for n, tr in sched.trainers.items()}


def setup(cell) -> State:
    from repro_torch.core.alignment import AlignmentRegistry
    from repro_torch.core.federation import FederationScheduler
    from repro_torch.core.ppat import PPATConfig
    from repro_torch.kge.data import KG

    st = State()
    st.cell, st.tick, st.epochs = cell, 0, []
    cfg, sc, dev = cell.cfg, cell.cfg["scheduler"], cell.device
    phases = trace.Phases(dev)
    st.splits, st.aligned = universe(cell)
    phases.end("universe")
    kgs = {}
    for n, s in cfg["owners"].items():
        kg = KG(n, s["entities"], s["relations"], st.splits[n]["train"], np.arange(s["entities"]))
        kg.train, kg.valid, kg.test = (st.splits[n][k] for k in ("train", "valid", "test"))
        kgs[n] = kg
    reg = AlignmentRegistry()
    a, b = cfg["aligned"]["pair"]
    reg.add_entities(a, b, *st.aligned[(a, b)])
    sched = FederationScheduler(
        kgs, dim=cfg["dim"], registry=reg, ppat_cfg=PPATConfig(**sc["ppat"]),
        aggregation=sc["aggregation"], procrustes_refine=sc["procrustes_refine"],
        use_virtual=sc["use_virtual"], update_epochs=sc["update_epochs"],
        score_metric=sc["score_metric"], score_split=sc["score_split"],
        score_max_test=sc["score_max_test"], margin=sc["margin"], batch_size=sc["batch_size"],
        seed=gen.stream_seed(cell.seed, "scheduler") % (1 << 31), device=dev,
        tick_impl=sc["tick_impl"], tick_sync=sc["tick_sync"], draws=Draws(st))
    for n, tr in sched.trainers.items():
        s = cfg["owners"][n]
        tr.params = gen.tables(dev, cell.seed, n, s["entities"], s["relations"], cfg["dim"])
    st.sched = sched
    st.accepted = {}

    def on_accept(owner, tick, params):
        if tick in CHECKED_TICKS:
            st.accepted[(tick, owner)] = {k: v.clone() for k, v in params.items()}

    sched.add_accept_listener(on_accept)
    phases.end("scheduler")
    st.init_scores = dict(sched.initial_training(sc["initial_epochs"]))
    st.after_init = _clone(sched)
    phases.end("initial training")
    _tick(st)                       # captures each signature's graphs
    st.at_tick = {1: st.after_init, 2: _clone(sched)}  # the tables at each checked tick's start
    phases.end("first tick")
    return st


def _tick(st: State) -> dict:
    sched = st.sched
    for n in sched.trainers:
        sched.broadcast(n)
    st.tick += 1
    sched.run(max_ticks=1)
    return dict(sched._tick_engine.last) if sched.tick_impl == "batched" else {}


def window(st: State, seconds: float) -> dict:
    counts = {"ticks": 0, "entries": 0, "captured": 0, "replays": 0, "eager_segments": 0}
    st.window_ticks = []
    t0 = time.perf_counter()
    while True:
        last = _tick(st)
        st.window_ticks.append(st.tick)
        counts["ticks"] += 1
        for k in ("entries", "captured", "replays", "eager_segments"):
            counts[k] += last.get(k, 0)
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    st.events = list(st.sched.events)
    st.counts = counts
    return {"window_s": window_s, "attempted": 2 * counts["ticks"],
            "failed": sum(e.fault is not None for e in st.events if e.kind != "init"),
            "metrics": {"tick_s": window_s / counts["ticks"]}, "counters": counts}


def free(st: State) -> None:
    st.sched = None


def _store(st: State, host: str, client: str):
    """The host's training store extended by the virtual triples of the
    handshake with ``client`` → (store, neighbors, relations)."""
    cfg = st.cell.cfg
    s = cfg["owners"][host]
    idx_c, idx_h = st.aligned[(client, host)]
    vs = fkge.virtual_structure(st.splits[client]["train"], idx_c, idx_h, s["entities"],
                                s["relations"], cfg["scheduler"]["max_neighbors"])
    if vs is None:
        return st.splits[host]["train"], np.zeros(0, np.int64), np.zeros(0, np.int64)
    neigh, rels, extra = vs
    return np.concatenate([st.splits[host]["train"], extra]), neigh, rels


def launches(st: State) -> dict:
    """The window's epoch-kernel and norm-projection launches, with each
    epoch's touched rows counted from the benchmark's own stores and draws."""
    cfg, dev = st.cell.cfg, st.cell.device
    sc, d = cfg["scheduler"], cfg["dim"]
    owners = list(cfg["owners"])
    stores = {h: ref.padded_store(_store(st, h, [o for o in owners if o != h][0])[0],
                                  sc["batch_size"], dev)[0] for h in owners}
    epochs, norms = [], []
    window = set(st.window_ticks)
    for tick, owner, n_pad, nb, batch, n_ent in st.epochs:
        if tick not in window:
            continue
        store = stores[owner]
        pos, neg = ref.epoch_batches(store, _train_draws(st.cell, tick, owner, 0, n_pad, nb, batch,
                                                         n_ent), batch)
        ue, ur = sparse_sgd_step.unique_rows(pos, neg)
        epochs.append({"nb": nb, "batch": batch, "d": d, "unique_ent": ue, "unique_rel": ur})
        norms.append({"e": n_ent, "d": d})
    return {"sparse_sgd_step": epochs, "normalize_entities": norms}


def _entry(st: State, start: dict, tick: int, host: str, client: str, dtype,
           half_batch: bool = False, retrain: bool = True):
    """One handshake entry in the reference from the tables ``start``;
    ``retrain=False`` leaves the retrain's epochs out."""
    cfg, dev = st.cell.cfg, st.cell.device
    sc = cfg["scheduler"]
    idx_c, idx_h = st.aligned[(client, host)]
    ic = torch.as_tensor(idx_c, device=dev)
    ih = torch.as_tensor(idx_h, device=dev)
    n = len(idx_c)
    x = fkge.pad_rows(start[client]["ent"][ic])
    y = fkge.pad_rows(start[host]["ent"][ih])
    draws = _ppat_draws(st.cell, tick, host, client, n)
    w, n0, n1 = fkge.ppat(x, y, sc["ppat"], draws, dtype)
    w = w.float()
    eps = fkge.epsilon(n0.cpu().numpy(), n1.cpu().numpy(), sc["ppat"]["lam"], sc["ppat"]["delta"])
    synth = x @ w
    refine = fkge.procrustes(synth, y) if sc["procrustes_refine"] else None
    if refine is not None:
        synth = synth @ refine
    ent = start[host]["ent"].clone()
    ent[ih] = 0.5 * (ent[ih] + synth[:n])
    rel = start[host]["rel"].clone()
    store, neigh, rels = _store(st, host, client)
    if len(neigh):
        def gen_rows(e):
            out = e @ w
            return out if refine is None else out @ refine

        ent = torch.cat([ent, gen_rows(start[client]["ent"][torch.as_tensor(neigh, device=dev)])])
        rel = torch.cat([rel, gen_rows(start[client]["rel"][torch.as_tensor(rels, device=dev)])])
    n_pad, nb = gen.padded_batches(len(store), sc["batch_size"])
    batch = min(sc["batch_size"], len(store))
    ent, rel = ent.to(dtype), rel.to(dtype)
    for ep in range(sc["update_epochs"] if retrain else 0):
        ref.sgd_epoch(ent, rel, store, _train_draws(st.cell, tick, host, ep, n_pad, nb, batch,
                                                     ent.shape[0]),
                      lr=sc["lr"], margin=sc["margin"], batch=sc["batch_size"],
                      half_batch=half_batch)
    s = cfg["owners"][host]
    ent, rel = ent[: s["entities"]].float(), rel[: s["relations"]].float()
    return {"epsilon": eps, "score": _score(st, host, ent, rel), "ent": ent, "rel": rel}


def _score(st, host, ent, rel) -> float:
    """The backtrack's triple-classification accuracy on the valid split."""
    valid = st.splits[host]["valid"]
    neg = fkge.fixed_negatives(valid, st.cell.cfg["owners"][host]["entities"])
    return fkge.classification_accuracy(ent, rel, valid, neg)


def _leaf_norms(prog: dict, want: dict, start: dict, what: str):
    """Per leaf (owner/table) the norms of the program's and the reference's
    change from ``start``, each printed to standard error."""
    p, w = {}, {}
    for owner in want:
        for k in want[owner]:
            key = f"{owner}/{k}"
            p[key] = float((prog[owner][k] - start[owner][k]).norm())
            w[key] = float((want[owner][k] - start[owner][k]).norm())
            print(f"chipbench: {what} {key}: change {p[key]!r}, reference {w[key]!r}",
                  file=sys.stderr)
    return p, w


def _gaps(prog: dict, want: dict) -> dict:
    """The worst entity leaf's and the worst relation leaf's gap between the
    norms of the program's and the reference's change, each against the
    reference's norm of that leaf. The relation leaves are compared apart:
    Yago's 37 relation rows take some 540 updates each per step, and L1's
    sign gradient turns their rounding into a drift of a few percent."""
    out = {}
    for kind in ("ent", "rel"):
        keys = [k for k in want if k.endswith("/" + kind)]
        out[kind] = max(abs(prog[k] - want[k]) / max(want[k], 1e-30) for k in keys)
    return out


def _initial(st: State, init: dict, dtype, half_batch: bool = False) -> dict:
    """Initial training in the reference from the benchmark's tables."""
    cell = st.cell
    cfg, sc = cell.cfg, cell.cfg["scheduler"]
    out = {}
    for n in cfg["owners"]:
        p = {k: v.to(dtype, copy=True) for k, v in init[n].items()}
        train = st.splits[n]["train"]
        n_pad, nb = gen.padded_batches(len(train), sc["batch_size"])
        batch = min(sc["batch_size"], len(train))
        for ep in range(sc["initial_epochs"]):
            ref.sgd_epoch(p["ent"], p["rel"], train,
                          _train_draws(cell, 0, n, ep, n_pad, nb, batch,
                                       cfg["owners"][n]["entities"]),
                          lr=sc["lr"], margin=sc["margin"], batch=sc["batch_size"],
                          half_batch=half_batch)
        out[n] = {k: v.float() for k, v in p.items()}
    return out


#: what may take the program's place in ``check``: the reference in a dtype,
#: with each step over half of its batch, or with each handshake's retrain
#: left out. ``bf16``, ``half_batch`` and ``unchanged_retrain`` must come out
#: not correct; ``f64`` is the witness of how far float32 rounding alone
#: moves each number.
CONTROLS = {"bf16": {"dtype": torch.bfloat16}, "half_batch": {"half_batch": True},
            "unchanged_retrain": {"retrain": False}, "f64": {"dtype": torch.float64}}


def check(st: State, control: str = "") -> list:
    """See the module's docstring. With ``control`` (a key of ``CONTROLS``)
    the reference in that form takes the program's place: it retrains each
    entry and decides its accept as the program does."""
    cell, dev = st.cell, st.cell.device
    cfg = cell.cfg
    lim = cell.limits
    ctl = CONTROLS[control] if control else None
    low = None if ctl is None else ctl.get("dtype", torch.float32)
    half = ctl is not None and ctl.get("half_batch", False)
    owners = list(cfg["owners"])
    init = {n: gen.tables(dev, cell.seed, n, cfg["owners"][n]["entities"],
                          cfg["owners"][n]["relations"], cfg["dim"]) for n in owners}
    want = _initial(st, init, torch.float32)
    got = st.after_init if low is None else _initial(st, init, low, half)
    gaps = _gaps(*_leaf_norms(got, want, init, "initial training"))
    # the backtrack's score of the program's own tables, worked out again
    score_gap = 0.0
    for n in owners:
        prog = st.init_scores[n] if low is None else _score(st, n, got[n]["ent"].to(low),
                                                            got[n]["rel"].to(low))
        score_gap = max(score_gap, abs(prog - _score(st, n, got[n]["ent"], got[n]["rel"])))
    del want, got, init
    ev = {(e.tick, e.host): e for e in st.events if e.kind == "ppat"}
    eps_gap = after_gap = 0.0
    flips = n_accepted = n_entries = 0
    for tick in CHECKED_TICKS:
        start = st.at_tick[tick]
        for host in owners:
            client = [o for o in owners if o != host][0]
            e = ev.get((tick, host))
            if e is None:
                return [("entries_missing", 1.0, 0.0)]
            r = _entry(st, start, tick, host, client, torch.float32)
            if low is None:
                got_eps, got_score, accepted = e.epsilon, e.score_after, e.accepted
                tables = st.accepted.get((tick, host))
            else:
                g = _entry(st, start, tick, host, client, low, half, ctl.get("retrain", True))
                got_eps = g["epsilon"]
                got_score = _score(st, host, g["ent"].to(low), g["rel"].to(low))
                accepted = got_score > e.score_before
                tables = {"ent": g["ent"], "rel": g["rel"]}
            print(f"chipbench: tick {tick} host {host}: score {e.score_before!r} -> "
                  f"{got_score!r} ({'accepted' if accepted else 'restored'}), reference "
                  f"{r['score']!r}", file=sys.stderr)
            n_entries += 1
            eps_gap = max(eps_gap, abs(got_eps - r["epsilon"]) / r["epsilon"])
            # the retrain's result, accepted or restored: its score against
            # the score of the reference's retrain, and its accept decision
            # wherever the reference's score lies beyond that limit from the
            # score before (inside it, a near tie may fall either way)
            after_gap = max(after_gap, abs(got_score - r["score"]))
            clear = abs(r["score"] - e.score_before) > lim["score_after_gap"]
            flips += int(clear and accepted != (r["score"] > e.score_before))
            if not accepted:
                continue
            n_accepted += 1
            if tables is None:
                return [("accepted_tables_missing", 1.0, 0.0)]
            score_gap = max(score_gap,
                            abs(got_score - _score(st, host, tables["ent"], tables["rel"])))
            more = _gaps(*_leaf_norms({host: tables}, {host: {"ent": r["ent"], "rel": r["rel"]}},
                                      {host: start[host]}, f"tick {tick} entry"))
            gaps = {k: max(gaps[k], more[k]) for k in gaps}
    print(f"chipbench: {n_accepted} of {n_entries} checked entries accepted", file=sys.stderr)
    return [("ent_change_gap", gaps["ent"], lim["ent_change_gap"]),
            ("rel_change_gap", gaps["rel"], lim["rel_change_gap"]),
            ("score_gap", score_gap, lim["score_gap"]),
            ("score_after_gap", after_gap, lim["score_after_gap"]),
            ("accept_flips", flips, 0),
            ("epsilon_gap", eps_gap, lim["epsilon_gap"]),
            ("graphs_captured_in_window", st.counts["captured"], 0)]
