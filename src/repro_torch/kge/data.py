"""KG triple stores and the synthetic LOD-like universe generator.

Raw LOD dumps (Dbpedia, Geonames, …) are not available offline, so we generate
a *universe* of latent entities with translational relational structure
(h + r ≈ t in latent space) and carve per-owner KGs out of it. Entities shared
between two KGs are exactly the paper's "aligned entities" (Tab. 3) — because
they are literally the same latent object, cross-KG signal exists and
federation *can* help, which is the property the paper's experiments rely on.

``PAPER_KG_STATS`` mirrors Tab. 2 (entity/relation/triple counts); the default
``scale`` shrinks it for CPU runs while preserving relative sizes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# (name, #relations, #entities, #triples) — Tab. 2 of the paper.
PAPER_KG_STATS = [
    ("Dbpedia", 14085, 491078, 1373644),
    ("Geonames", 6, 300000, 1163878),
    ("Yago", 37, 286389, 1824322),
    ("Geospecies", 38, 41943, 782120),
    ("Pokepedia", 28, 238008, 548883),
    ("Sandrart", 20, 14765, 18243),
    ("Hellenic", 4, 11145, 33296),
    ("Lexvo", 6, 9810, 147211),
    ("Tharawat", 12, 4693, 31130),
    ("Whisky", 11, 642, 1339),
    ("WorldLift", 10, 357, 1192),
]

# (kg_a, kg_b, #aligned entities) — Tab. 3.
PAPER_ALIGNMENTS = [
    ("Geonames", "Dbpedia", 118939),
    ("Yago", "Dbpedia", 123853),
    ("Yago", "Geonames", 53553),
    ("Sandrart", "Dbpedia", 379),
    ("Dbpedia", "Lexvo", 507),
    ("Dbpedia", "Tharawat", 403),
    ("Dbpedia", "Whisky", 70),
    ("Dbpedia", "WorldLift", 25),
    ("Lexvo", "Yago", 77),
    ("Whisky", "Yago", 49),
    ("Dbpedia", "Pokepedia", 27),
    ("Dbpedia", "Geospecies", 133),
    ("Geonames", "Geospecies", 89),
    ("Dbpedia", "Hellenic", 41),
    ("Geonames", "Lexvo", 245),
    ("Geonames", "Tharawat", 90),
    ("Geonames", "Whisky", 39),
    ("Yago", "WorldLift", 18),
    ("Yago", "Tharawat", 266),
]


@dataclass
class KG:
    """One owner's knowledge graph with train/valid/test splits (90:5:5)."""

    name: str
    num_entities: int
    num_relations: int
    triples: np.ndarray  # (N, 3) int32 [h, r, t] — local ids
    universe_ids: np.ndarray  # (num_entities,) global entity ids
    train: np.ndarray = field(default=None)
    valid: np.ndarray = field(default=None)
    test: np.ndarray = field(default=None)

    def split(self, rng: np.random.Generator):
        n = len(self.triples)
        order = rng.permutation(n)
        tr, va = int(0.9 * n), int(0.95 * n)
        self.train = self.triples[order[:tr]]
        self.valid = self.triples[order[tr:va]]
        self.test = self.triples[order[va:]]

    def aligned_with(self, other: "KG") -> Tuple[np.ndarray, np.ndarray]:
        """Local ids (this, other) of shared universe entities."""
        common, idx_self, idx_other = np.intersect1d(
            self.universe_ids, other.universe_ids, return_indices=True
        )
        return idx_self.astype(np.int32), idx_other.astype(np.int32)


def synthesize_universe(
    *,
    seed: int = 0,
    scale: float = 1 / 400,
    latent_dim: int = 12,
    kg_stats: Optional[List[Tuple[str, int, int, int]]] = None,
    alignments: Optional[List[Tuple[str, str, int]]] = None,
    noise: float = 0.05,
    density_boost: float = 8.0,
) -> Dict[str, KG]:
    """Build the 11-KG universe mirroring Tab. 2 / Tab. 3 at ``scale``.

    ``density_boost`` multiplies triple counts relative to the scaled entity
    counts: at 1/400 scale the paper's raw triples-per-entity (~3) is too
    sparse for any KGE model to generalize (loss→0, test accuracy ~chance —
    pure memorization), so scaled KGs keep the paper's *relative* sizes but
    are denser. Recorded as a deviation in EXPERIMENTS.md.
    """
    rng = np.random.default_rng(seed)
    kg_stats = kg_stats or PAPER_KG_STATS
    alignments = alignments if alignments is not None else PAPER_ALIGNMENTS

    def sc(x, lo):
        return max(lo, int(round(x * scale)))

    # small relation vocabularies are kept verbatim; only large ones scale
    sizes = {
        n: (r if r <= 50 else sc(r, 8), sc(e, 150), sc(t * density_boost, 1500))
        for n, r, e, t in kg_stats
    }

    total_universe = int(sum(e for _, e, _ in sizes.values()) * 0.8)
    z = rng.normal(0, 1.0, (total_universe, latent_dim)).astype(np.float32)

    # global relation pool with translational latents
    total_rel = sum(r for r, _, _ in sizes.values())
    rel_z = rng.normal(0, 0.6, (total_rel, latent_dim)).astype(np.float32)

    # assign entity subsets: overlapping pairs first (aligned entities are
    # shared universe ids), then fill up with private ids.
    assigned: Dict[str, set] = {n: set() for n in sizes}
    pool = rng.permutation(total_universe)
    cursor = 0

    def take(k):
        nonlocal cursor
        out = pool[cursor : cursor + k]
        cursor += k
        if len(out) < k:  # wrap (overlap is fine — extra incidental alignment)
            out = np.concatenate([out, rng.choice(total_universe, k - len(out))])
        return out

    for a, b, n_al in alignments:
        n_al = sc(n_al, 2)
        cap = min(sizes[a][1], sizes[b][1])
        n_al = min(n_al, int(0.6 * cap))
        shared = take(n_al)
        assigned[a].update(shared.tolist())
        assigned[b].update(shared.tolist())

    rel_cursor = 0
    kgs: Dict[str, KG] = {}
    for name, (n_rel, n_ent, n_tri) in sizes.items():
        ids = list(assigned[name])
        if len(ids) < n_ent:
            ids.extend(take(n_ent - len(ids)).tolist())
        ids = np.array(sorted(set(ids)), dtype=np.int64)[:n_ent]
        n_ent = len(ids)

        rel_ids = np.arange(rel_cursor, rel_cursor + n_rel)
        rel_cursor += n_rel

        # triples: sample (h, r), tail = exact nearest entity to z_h + z_r
        # (+ noise) → genuinely translational structure a TransX model can fit,
        # consistent across KGs because aligned entities share latents.
        h_idx = rng.integers(0, n_ent, n_tri)
        r_idx = rng.integers(0, n_rel, n_tri)
        target = z[ids[h_idx]] + rel_z[rel_ids[r_idx]]
        target += rng.normal(0, noise, target.shape).astype(np.float32)
        ent_z = z[ids]  # (E, L)
        t_idx = np.empty(n_tri, dtype=np.int64)
        step = max(1, 2_000_000 // max(1, n_ent))
        for s in range(0, n_tri, step):
            blk = target[s : s + step]
            d = (
                np.sum(blk**2, axis=1)[:, None]
                - 2 * blk @ ent_z.T
                + np.sum(ent_z**2, axis=1)[None]
            )
            d[np.arange(len(blk)), h_idx[s : s + step]] = np.inf  # no self-loop
            t_idx[s : s + step] = np.argmin(d, axis=1)
        triples = np.stack([h_idx, r_idx, t_idx], axis=1).astype(np.int32)
        triples = np.unique(triples, axis=0)

        kg = KG(
            name=name,
            num_entities=n_ent,
            num_relations=n_rel,
            triples=triples,
            universe_ids=ids,
        )
        kg.split(rng)
        kgs[name] = kg
    return kgs


def equal_shape_universe(
    n_owners: int = 8,
    *,
    entities: int = 160,
    relations: int = 8,
    triples: int = 1300,
    shared: int = 40,
    seed: int = 0,
) -> Dict[str, KG]:
    """N structurally IDENTICAL KG owners: every owner has the same entity /
    relation / triple-store / split extents, and every pair shares the same
    ``shared`` aligned entities (universe ids 0..shared-1, occupying the same
    local slots in every owner).

    ``synthesize_universe`` deduplicates generated triples, so even owners
    built from identical stats end up a few triples apart — enough to change
    padded store shapes. This function pins shapes exactly: it is the
    deployment the paper scales to (N symmetric KG processes) and the shape
    the tick engine's trace-time program dedup targets — all N owners share
    ONE compiled tick-entry program per tick kind, and with owner-sticky
    placement each owner's chunk position in the shard_map group equals its
    home device. Owner counts that don't match the mesh (5 owners on 3 or 8
    devices — the pow-2 chunk-extent tests) are exactly as cheap: partial
    chunks pad with dummy entries instead of compiling new extents.
    """
    kgs: Dict[str, KG] = {}
    private = entities - shared
    if private < 0:
        raise ValueError("shared aligned block exceeds the entity count")
    for i in range(n_owners):
        rng = np.random.default_rng(seed + 7919 * i)
        h = rng.integers(0, entities, triples)
        r = rng.integers(0, relations, triples)
        t = (h + 1 + rng.integers(0, entities - 1, triples)) % entities
        tri = np.stack([h, r, t], axis=1).astype(np.int32)
        ids = np.concatenate(
            [np.arange(shared), shared + i * private + np.arange(private)]
        ).astype(np.int64)
        kg = KG(
            name=f"K{i}",
            num_entities=entities,
            num_relations=relations,
            triples=tri,
            universe_ids=ids,
        )
        kg.split(rng)
        kgs[kg.name] = kg
    return kgs


def corrupt_triples(
    rng: np.random.Generator, triples: np.ndarray, num_entities: int
) -> np.ndarray:
    """Negative sampling: corrupt head or tail uniformly (ratio 1:1, §4.1.1)."""
    neg = triples.copy()
    n = len(neg)
    corrupt_head = rng.random(n) < 0.5
    rand_ent = rng.integers(0, num_entities, n)
    neg[corrupt_head, 0] = rand_ent[corrupt_head]
    neg[~corrupt_head, 2] = rand_ent[~corrupt_head]
    return neg
