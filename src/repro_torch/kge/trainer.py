"""Local KGE training — the "Train" step of Fig. 2 / Alg. 1 line 2.

SGD on the margin ranking loss with 1:1 negative sampling, at OpenKE's
defaults as the paper uses them (§4.1.1): lr 0.5, batch 100, margin 4.

The default path is the training engine (``kge.engine``): sparse steps on
bucket-padded tables; on the card, TransE and DistMult run each epoch as
one launch of the fused ``sparse_update`` kernel, and elsewhere (as in the
JAX package off the TPU) every family takes the autograd sparse step.
``impl="reference"`` keeps the dense host loop of ``_epoch`` calls with
numpy negative sampling as the parity oracle; it draws from the same
``np.random.default_rng(seed)`` stream as the JAX package's, so the two are
comparable draw for draw.

The steps update tables in place. So everything that keeps a table past the
next step holds a copy: ``snapshot``/``restore`` clone, ``strip_virtual``
clones the rows it keeps, and a published serving ``TableVersion`` clones
what it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device, resolve_train_impl
from repro_torch.kge.data import corrupt_triples
from repro_torch.kge.engine import (
    Draws,
    as_device,
    pad_triples,
    train_epochs_device,
)
from repro_torch.kge.models import (
    KGEModel,
    Params,
    init_kge,
    margin_loss,
    normalize_entities,
    score_triples,
    virtual_pad_rows,
)


def _epoch(params: Params, model: KGEModel, pos: torch.Tensor, neg: torch.Tensor,
           lr: float) -> Tuple[Params, torch.Tensor]:
    """Dense epoch (``impl="reference"``) over pos/neg (nb, B, 3): every
    step differentiates the whole tables and writes ``p − lr·g`` to every
    row. Returns new tables and the mean step loss; ``params`` is left as
    it was."""
    p = dict(params)
    losses = []
    for bp, bn in zip(pos, neg):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            sp = score_triples(leaves, model, bp[:, 0], bp[:, 1], bp[:, 2])
            sn = score_triples(leaves, model, bn[:, 0], bn[:, 1], bn[:, 2])
            loss = margin_loss(sp, sn, model.margin)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        p = {k: v if g is None else v - lr * g for (k, v), g in zip(p.items(), grads)}
        losses.append(loss.detach())
    return normalize_entities(p), torch.stack(losses).mean()


class KGETrainer:
    """Owns one KG's embedding training state (one 'process' of the paper),
    on ``device`` (the current CUDA device by default)."""

    def __init__(self, kg, family: str = "transe", dim: int = 100, *,
                 lr: float = 0.5, batch_size: int = 100, margin: float = 4.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.kg = kg
        self.model = KGEModel(
            family=family,
            num_entities=kg.num_entities,
            num_relations=kg.num_relations,
            dim=dim,
            margin=margin,
        )
        self.lr = lr
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.params = init_kge(seed, self.model, device=self.device)
        self._virtual: Tuple[int, int] = (0, 0)  # extra (ent, rel) rows
        self._extra_triples: Optional[np.ndarray] = None
        #: the engine's sampling stream (the JAX package's engine key)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 7919)
        #: padded triple store on the params' device, rebuilt only when the
        #: store changes (extend/strip) or its size, batch or device does
        self._tri_cache: Optional[Tuple[tuple, torch.Tensor]] = None

    # ---- virtual entities/relations (core.aggregation) -----------------
    def extend_tables(self, v_ent, v_rel, extra_triples: np.ndarray) -> None:
        """Temporarily append DP-translated virtual rows + their triples."""
        assert self._virtual == (0, 0), "virtual extension already active"
        dev = self.params["ent"].device
        v_ent = as_device(v_ent, dev).float()
        v_rel = as_device(v_rel, dev).float()
        self.params = dict(self.params)
        self.params["ent"] = torch.cat([self.params["ent"], v_ent])
        self.params["rel"] = torch.cat([self.params["rel"], v_rel])
        pads = virtual_pad_rows(self.params, self.model.dim, len(v_ent), len(v_rel))
        for k, pad in pads.items():
            self.params[k] = torch.cat([self.params[k], pad])
        self._virtual = (len(v_ent), len(v_rel))
        self._extra_triples = np.asarray(extra_triples, np.int32)
        self._tri_cache = None  # store contents changed, not just its length
        self.model = dataclasses.replace(
            self.model,
            num_entities=self.model.num_entities + len(v_ent),
            num_relations=self.model.num_relations + len(v_rel),
        )

    def strip_virtual(self) -> None:
        """Remove virtual rows before responding to other hosts (§3.2.1).
        The kept rows are copies, not views of the extended tables."""
        ne, nr = self._virtual
        if ne == 0 and nr == 0:
            return
        self.params = dict(self.params)
        for k in ("ent", "ent_p"):
            if k in self.params:
                self.params[k] = self.params[k][: len(self.params[k]) - ne].clone()
        for k in ("rel", "rel_p", "norm_vec", "proj"):
            if k in self.params:
                self.params[k] = self.params[k][: len(self.params[k]) - nr].clone()
        self.model = dataclasses.replace(
            self.model,
            num_entities=self.model.num_entities - ne,
            num_relations=self.model.num_relations - nr,
        )
        self._virtual = (0, 0)
        self._extra_triples = None
        self._tri_cache = None

    def consume_engine_key(self) -> torch.Generator:
        """The engine's sampling generator: the port's counterpart of the
        JAX package's engine key stream. A ``torch.Generator`` is stateful,
        so there is no subkey to split off: the next ``train_epochs`` (and
        anything else handed this generator) draws from it and advances it.
        Seeded ``seed + 7919``, as the JAX package seeds its key."""
        return self._gen

    def train_epochs(self, epochs: int = 1, *, impl: Optional[str] = None,
                     draws: Optional[Sequence[Draws]] = None) -> float:
        """Train ``epochs`` epochs; returns the last epoch's mean loss.

        ``impl``: ``fused`` | ``sparse`` | ``reference`` (or the JAX names
        ``pallas`` | ``xla``), resolved by ``resolve_train_impl``.
        ``draws`` replaces the engine's own draws with explicit ones, one
        ``(perm, corrupt_head, rand_ent)`` per epoch (the randomness seam);
        the reference path draws from ``self.rng`` and ignores it."""
        impl = resolve_train_impl(impl, self.model.family, self.params["ent"].device)
        tr = self._train_triples()
        if impl == "reference":
            return self._train_epochs_reference(tr, epochs)
        self.params, losses = train_epochs_device(
            self.params, self.model, self._padded_triples(tr),
            epochs=epochs, batch_size=self.batch_size, lr=self.lr, impl=impl,
            generator=None if draws is not None else self.consume_engine_key(),
            draws=draws,
        )
        return float(losses[-1])

    def _train_triples(self) -> np.ndarray:
        tr = self.kg.train
        if self._extra_triples is not None and len(self._extra_triples):
            tr = np.concatenate([tr, self._extra_triples])
        return tr

    def _padded_triples(self, tr: np.ndarray) -> torch.Tensor:
        b = min(self.batch_size, len(tr))
        dev = self.params["ent"].device
        key = (len(tr), b, dev)
        if self._tri_cache is None or self._tri_cache[0] != key:
            padded = pad_triples(torch.as_tensor(np.asarray(tr, np.int64), device=dev), b)
            self._tri_cache = (key, padded)
        return self._tri_cache[1]

    def _train_epochs_reference(self, tr: np.ndarray, epochs: int) -> float:
        """Host loop, numpy sampling, dense ``_epoch`` updates."""
        dev = self.params["ent"].device
        b = min(self.batch_size, len(tr))
        loss = 0.0
        for _ in range(epochs):
            order = self.rng.permutation(len(tr))
            nb = len(tr) // b
            pos = tr[order[: nb * b]].reshape(nb, b, 3)
            # corrupt against the EXTENDED entity count so virtual rows are
            # sampled as negatives while a virtual extension is active
            neg = corrupt_triples(self.rng, pos.reshape(-1, 3), self.model.num_entities)
            neg = neg.reshape(nb, b, 3)
            self.params, mean = _epoch(
                self.params, self.model,
                torch.as_tensor(pos.astype(np.int64), device=dev),
                torch.as_tensor(neg.astype(np.int64), device=dev), self.lr,
            )
            loss = float(mean)
        return loss

    # ---- embedding table access (the FKGE surface) --------------------
    def _ids(self, idx) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.params["ent"].device)

    def get_entity_embeddings(self, idx) -> torch.Tensor:
        return self.params["ent"][self._ids(idx)]

    def get_relation_embeddings(self, idx) -> torch.Tensor:
        return self.params["rel"][self._ids(idx)]

    def set_entity_embeddings(self, idx, emb) -> None:
        """Overwrite the rows ``idx`` of the entity table, in place."""
        self.params["ent"][self._ids(idx)] = as_device(emb, self.params["ent"].device).float()

    def set_relation_embeddings(self, idx, emb) -> None:
        """Overwrite the rows ``idx`` of the relation table, in place."""
        self.params["rel"][self._ids(idx)] = as_device(emb, self.params["rel"].device).float()

    def snapshot(self) -> Params:
        """A copy of every table: later in-place training leaves it as it is."""
        return {k: v.clone() for k, v in self.params.items()}

    def restore(self, snap: Params) -> None:
        """Take copies of ``snap``'s tables, so ``snap`` stays restorable."""
        self.params = {k: v.clone() for k, v in snap.items()}
