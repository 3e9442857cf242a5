"""Local training: one owner's ``KGETrainer.train_epochs(1)`` called again
and again, each epoch fed draws that the benchmark makes from the seed.

Set-up builds the owner's store and the trainer, gives it tables made from
the seed, and drives it through the first three epochs by the window's own
call and feed; the reference follows those three (``check``). The window
then trains epoch after epoch until ``seconds`` have passed; the rate is all
the store's triples trained in the window over the window's time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from chipbench import gen, trace
from chipbench.counts import sparse_sgd_step
from chipbench.reference import kge as ref

CHECKED_EPOCHS = 3


def _owner(cell):
    name = cell.mix["owner"]
    sizes = dict(cell.cfg["owners"][name], eval=cell.cfg["eval_triples"])
    return name, sizes


def _draws(cell, epoch: int, n_pad: int, nb: int, batch: int, e: int):
    g = gen.generator(cell.device, cell.seed, "train-draws", epoch)
    return gen.epoch_draws(g, n_pad, nb, batch, e)


def _norms(now, before):
    return {k: float((now[k] - before[k]).float().norm()) for k in before}


class State:
    pass


def setup(cell) -> State:
    from repro_torch.kge.data import KG
    from repro_torch.kge.trainer import KGETrainer

    st = State()
    st.cell = cell
    phases = trace.Phases(cell.device)
    name, sizes = _owner(cell)
    split = gen.owner_split(cell.device, cell.seed, name, sizes)
    e, r = sizes["entities"], sizes["relations"]
    kg = KG(name, e, r, split["train"], np.arange(e))
    kg.train, kg.valid, kg.test = split["train"], split["valid"], split["test"]
    t = cell.cfg["trainer"]
    st.batch, st.lr, st.margin = t["batch_size"], t["lr"], t["margin"]
    st.train = split["train"]
    st.e, st.d = e, cell.cfg["dim"]
    st.n_pad, st.nb = gen.padded_batches(len(st.train), st.batch)
    tr = KGETrainer(kg, cell.cfg["family"], dim=st.d, lr=st.lr, batch_size=st.batch,
                    margin=st.margin, seed=gen.stream_seed(cell.seed, "trainer") % (1 << 31),
                    device=cell.device)
    init = gen.tables(cell.device, cell.seed, name, e, r, st.d)
    tr.params = {k: v.clone() for k, v in init.items()}
    st.trainer = tr
    phases.end("store and trainer")
    # the first epochs, by the window's call and feed, held against the reference
    st.losses, st.changes = [], {}
    for i in range(CHECKED_EPOCHS):
        st.losses.append(tr.train_epochs(1, draws=[_draws(cell, i, st.n_pad, st.nb,
                                                           st.batch, e)]))
        if i == 0:
            st.changes[1] = _norms(tr.params, init)
    st.changes[CHECKED_EPOCHS] = _norms(tr.params, init)
    del init
    phases.end("first epochs")
    st.next_epoch = CHECKED_EPOCHS
    return st


def window(st: State, seconds: float) -> dict:
    tr, cell = st.trainer, st.cell
    first = st.next_epoch
    t0 = time.perf_counter()
    while True:
        tr.train_epochs(1, draws=[_draws(cell, st.next_epoch, st.n_pad, st.nb, st.batch, st.e)])
        st.next_epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    epochs = st.next_epoch - first
    st.window_epochs = range(first, st.next_epoch)
    return {"window_s": window_s, "attempted": epochs, "failed": 0,
            "metrics": {"train_triples_per_s": epochs * len(st.train) / window_s},
            "counters": {"epochs": epochs}}


def launches(st: State) -> dict:
    """Each window epoch's launch shapes, with the rows its steps touch
    counted from the benchmark's own store and draws."""
    store, nb = ref.padded_store(st.train, st.batch, st.cell.device)
    shapes = []
    for k in st.window_epochs:
        pos, neg = ref.epoch_batches(store, _draws(st.cell, k, st.n_pad, st.nb, st.batch, st.e),
                                     st.batch)
        ue, ur = sparse_sgd_step.unique_rows(pos, neg)
        shapes.append({"nb": nb, "batch": st.batch, "d": st.d, "unique_ent": ue,
                       "unique_rel": ur})
    return {"sparse_sgd_step": shapes,
            "normalize_entities": [{"e": st.e, "d": st.d}] * len(shapes)}


def free(st: State) -> None:
    st.trainer = None


def _reference(st: State, control: str = "") -> dict:
    """The first three epochs in the reference from the benchmark's tables
    and draws; ``control`` runs it in ``bfloat16`` (``"bf16"``) or with
    half of each batch (``"half_batch"``)."""
    cell = st.cell
    name, sizes = _owner(cell)
    init = gen.tables(cell.device, cell.seed, name, sizes["entities"], sizes["relations"], st.d)
    dtype = torch.bfloat16 if control == "bf16" else torch.float32
    p = {k: v.to(dtype, copy=True) for k, v in init.items()}
    losses, changes = [], {}
    for i in range(CHECKED_EPOCHS):
        losses.append(ref.sgd_epoch(p["ent"], p["rel"], st.train,
                                    _draws(cell, i, st.n_pad, st.nb, st.batch, st.e),
                                    lr=st.lr, margin=st.margin, batch=st.batch,
                                    half_batch=control == "half_batch"))
        if i == 0:
            changes[1] = _norms(p, init)
    changes[CHECKED_EPOCHS] = _norms(p, init)
    return {"losses": losses, "changes": changes}


def check(st: State, control: str = "") -> list:
    """Each of the first three epochs' loss, the first epoch's change and
    the change after three, by the worst leaf, against the reference. With
    ``control`` the reference in that form takes the program's place."""
    prog = (_reference(st, control) if control
            else {"losses": st.losses, "changes": st.changes})
    want = _reference(st)
    lim = st.cell.limits
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    return [("loss_gap", loss_gap, lim["loss_gap"]),
            ("first_change_gap", ref.leaf_gap(prog["changes"][1], want["changes"][1]),
             lim["first_change_gap"]),
            ("change3_gap", ref.leaf_gap(prog["changes"][CHECKED_EPOCHS],
                                         want["changes"][CHECKED_EPOCHS]),
             lim["change3_gap"])]
