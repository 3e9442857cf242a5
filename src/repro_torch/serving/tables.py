"""Versioned serving tables: what a KGE serving process holds.

``FilterPack`` — the padded CSR known-true filter over (h, r) keys, built
once from the owner's known triples. The pad width is a power of two over
the longest row, plus a trailing all(−1) sentinel row for unknown keys.
Known triples outlive table versions: one pack serves every version.

``TableVersion`` — one immutable published snapshot of an owner's tables:
a copy of the params dict, a per-version non-finite-row bitmask (one
``isfinite`` reduction per table on the tables' device; request validation
is then an O(B) host lookup), and a per-device copy cache. The copy is taken
when the version is built, because the trainer updates its tables in place:
without it, a training step after a publish would change the answers of
requests already pinned to that version. Staging onto the device the copy
sits on is zero-copy; every other device costs one counted transfer.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.distributed import committed_device
from repro_torch.kge.eval import _filter_mask


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class FilterPack:
    """Padded CSR filter rows for tail queries, one row per known (h, r) key
    (in the order the keys first occur, each row its distinct tails
    ascending) plus a trailing all(−1) sentinel row for unknown keys. Built
    by sorting the known triples, not by a Python pass over them."""

    def __init__(self, known_triples, num_entities: int):
        known = (
            np.zeros((0, 3), np.int64) if known_triples is None
            else np.asarray(known_triples, np.int64).reshape(-1, 3)
        )
        self.num_entities = int(num_entities)
        self._known = known
        self._span = int(known[:, 1].max()) + 1 if len(known) else 1
        code = known[:, 0] * self._span + known[:, 1]
        self._keys, first = np.unique(code, return_index=True)
        # row of each sorted key: keys are numbered in first-occurrence order
        self._row_of_key = np.empty(len(self._keys), np.int64)
        self._row_of_key[np.argsort(first, kind="stable")] = np.arange(len(self._keys))
        order = np.lexsort((known[:, 2], code))
        code, tail = code[order], known[order, 2]
        fresh = np.ones(len(code), bool)
        fresh[1:] = (code[1:] != code[:-1]) | (tail[1:] != tail[:-1])
        code, tail = code[fresh], tail[fresh]
        key_at = np.searchsorted(self._keys, code)
        counts = np.bincount(key_at, minlength=len(self._keys))
        self.width = _pow2(int(counts.max()) if len(counts) else 1)
        self.rows = np.full((len(self._keys) + 1, self.width), -1, np.int32)
        starts = np.cumsum(counts) - counts
        self.rows[self._row_of_key[key_at], np.arange(len(code)) - starts[key_at]] = tail
        self._masks = None

    @property
    def hr_t(self) -> Dict[Tuple[int, int], set]:
        """(h, r) → {t} over the known triples, as ``kge.eval._filter_mask``."""
        return self._filter_mask()[0]

    @property
    def rt_h(self) -> Dict[Tuple[int, int], set]:
        """(r, t) → {h} over the known triples."""
        return self._filter_mask()[1]

    def _filter_mask(self):
        if self._masks is None:
            self._masks = _filter_mask(self._known, self.num_entities)
        return self._masks

    def row_index(self, h: np.ndarray, r: np.ndarray) -> np.ndarray:
        sentinel = len(self.rows) - 1
        h = np.asarray(h, np.int64).reshape(-1)
        r = np.asarray(r, np.int64).reshape(-1)
        if not len(self._keys):
            return np.full(len(h), sentinel, np.int64)
        code = h * self._span + r
        at = np.minimum(np.searchsorted(self._keys, code), len(self._keys) - 1)
        found = (self._keys[at] == code) & (h >= 0) & (r >= 0) & (r < self._span)
        return np.where(found, self._row_of_key[at], sentinel)

    def rows_for(self, h: np.ndarray, r: np.ndarray) -> np.ndarray:
        """(B, width) int32 known-tail filter rows for (h, r) queries."""
        return self.rows[self.row_index(h, r)]


def check_id_range(name: str, ids, limit: int) -> np.ndarray:
    """Serving boundary: ids arrive from untrusted callers, and an
    out-of-range id would otherwise gather the wrong row (negative ids
    wrap) or fault inside a kernel."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    bad = ids[(ids < 0) | (ids >= limit)]
    if bad.size:
        raise ValueError(
            f"{name} ids must be in [0, {limit}); got "
            f"{bad[:5].tolist()}{'…' if bad.size > 5 else ''}"
        )
    return ids


def _bad_row_mask(params, keys, n: int) -> np.ndarray:
    """(n,) bool: rows with any NaN/Inf in any of the named tables (a row of
    a 3-D table such as TransR's ``proj`` is its whole matrix). The
    reduction runs where the tables sit; only the boolean vector comes to
    the host. Rows past ``n`` (virtual-entity extensions) are ignored."""
    bad = np.zeros(n, np.bool_)
    for k in keys:
        tab = params.get(k)
        if tab is None:
            continue
        m = (~torch.isfinite(tab.reshape(tab.shape[0], -1)).all(dim=1)).cpu().numpy()
        bad[: m.shape[0]] |= m[:n]
    return bad


class TableVersion:
    """One immutable published (owner, version) snapshot of serving tables.
    It holds its own copy of ``params``: whatever later writes into the
    source tables (an in-place training step) leaves the version as it was."""

    def __init__(self, params, model, filters: FilterPack, *,
                 version: int = 0, owner: Optional[str] = None):
        self.params = {k: v.clone() for k, v in params.items()}
        self.model = model
        self.filters = filters
        self.version = int(version)
        self.owner = owner
        self.ent_bad = _bad_row_mask(self.params, ("ent", "ent_im"),
                                     model.num_entities)
        self.rel_bad = _bad_row_mask(self.params, ("rel", "rel_im", "proj"),
                                     model.num_relations)
        #: per-device copies, filled by ``on()``
        self._ondev: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        #: copies made to other devices — 0 for the device the params sit on
        self.transfers = 0

    def on(self, device) -> Dict[str, torch.Tensor]:
        """The tables on ``device``: the version's own dict where it
        already sits (zero-copy), else one copy made on first use and reused
        afterwards."""
        device = torch.device(device)
        got = self._ondev.get(device)
        if got is None:
            if committed_device(self.params) == device:
                got = self.params
            else:
                got = {k: v.to(device, non_blocking=True) for k, v in self.params.items()}
                self.transfers += 1
            self._ondev[device] = got
        return got

    def check_finite(self, name: str, bad_mask: np.ndarray,
                     ids: np.ndarray) -> None:
        """O(B) bitmask lookup: refuse ids whose rows are NaN/Inf in this
        version, naming them."""
        bad = ids[bad_mask[ids]]
        if bad.size:
            raise ValueError(
                f"non-finite query embedding: {name} ids "
                f"{bad[:5].tolist()}{'…' if bad.size > 5 else ''} "
                f"have NaN/Inf rows in this table version"
            )
