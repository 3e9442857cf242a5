"""Inputs made from ``--seed``: triples, owners, alignments, initial tables
and the training and handshake draws, each from its own named stream.

Copied from the generators the repo's chip smoke test used (``draw_known``,
``make_kg``, ``fed_universe``, the engine's ``draw_epoch`` and the
handshake's ``draw_ppat``), moved onto the device: every draw is a few large
calls on a ``torch.Generator`` of the card, so the same seed gives the same
inputs on the same device, and a later change to the program cannot move
them. Only ``torch`` and ``numpy`` are imported here.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for the stream ``names`` of run seed ``seed``: streams
    of one seed are independent, and any whole number is a valid seed."""
    text = repr((int(seed),) + tuple(names)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, *names))
    return g


def triples(device, seed: int, name: str, e: int, r: int, n: int) -> np.ndarray:
    """(n, 3) int64 uniform triples over ``e`` entities and ``r`` relations,
    drawn on ``device`` and returned on the host."""
    g = generator(device, seed, "triples", name)
    h = torch.randint(0, e, (n,), generator=g, device=g.device)
    rel = torch.randint(0, r, (n,), generator=g, device=g.device)
    t = torch.randint(0, e, (n,), generator=g, device=g.device)
    return torch.stack([h, rel, t], 1).cpu().numpy()


def sample_rows(device, seed: int, name: str, n: int, k: int) -> np.ndarray:
    """``k`` distinct row numbers of ``n``, in draw order."""
    g = generator(device, seed, "sample", name)
    return torch.randperm(n, generator=g, device=g.device)[:k].cpu().numpy()


def owner_split(device, seed: int, name: str, sizes: Dict) -> Dict[str, np.ndarray]:
    """An owner's splits: ``train`` the uniform triples, ``valid`` and
    ``test`` ``sizes["eval"]`` triples each sampled from train (no dataset
    can be fetched, so the splits stand in for the paper's)."""
    tr = triples(device, seed, name, sizes["entities"], sizes["relations"], sizes["triples"])
    k = min(int(sizes["eval"]), len(tr))
    return {"train": tr,
            "valid": tr[sample_rows(device, seed, name + "/valid", len(tr), k)],
            "test": tr[sample_rows(device, seed, name + "/test", len(tr), k)]}


def alignment(device, seed: int, e_a: int, e_b: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` aligned pairs: distinct ids of the first owner (ascending) and
    distinct ids of the second, paired in draw order."""
    a = np.sort(sample_rows(device, seed, "align/a", e_a, n))
    b = sample_rows(device, seed, "align/b", e_b, n)
    return a.astype(np.int64), b.astype(np.int64)


def tables(device, seed: int, name: str, e: int, r: int, d: int) -> Dict[str, torch.Tensor]:
    """TransE tables uniform in ±6/√d (the port's and the paper's init), in
    float32 on ``device``."""
    g = generator(device, seed, "tables", name)
    b = 6.0 / math.sqrt(d)
    ent = torch.rand((e, d), generator=g, device=g.device).mul_(2 * b).sub_(b)
    rel = torch.rand((r, d), generator=g, device=g.device).mul_(2 * b).sub_(b)
    return {"ent": ent, "rel": rel}


def epoch_draws(g: torch.Generator, n_pad: int, nb: int, batch: int, num_entities: int):
    """One epoch's draws, laid out as the port's trainer takes them
    (``train_epochs(draws=...)``): a permutation of the padded store, which
    side of each positive is corrupted, and the corrupting entity."""
    dev = g.device
    perm = torch.randperm(n_pad, generator=g, device=dev)
    corrupt_head = torch.rand((nb, batch), generator=g, device=dev) < 0.5
    rand_ent = torch.randint(0, num_entities, (nb, batch), generator=g, device=dev)
    return perm, corrupt_head, rand_ent


def padded_batches(n: int, batch: int) -> Tuple[int, int]:
    """(n_pad, nb) of a store of ``n`` triples cycled up to a power-of-two
    number of ``batch``-triple steps, the layout the port trains on."""
    b = min(batch, n)
    nb = 1 << (max(1, -(-n // b)) - 1).bit_length()
    return nb * b, nb


def laplace(g: torch.Generator, shape) -> torch.Tensor:
    r = torch.rand((2, *shape), generator=g, device=g.device)
    return torch.log1p(-r[1]) - torch.log1p(-r[0])


def ppat_draws(g: torch.Generator, steps: int, batch: int, teachers: int, hidden: int,
               d: int, n: int) -> Dict[str, torch.Tensor]:
    """One handshake's draws: the discriminators' init (normal over
    √fan-in, zero biases; ``teachers`` stacked ones and a student) and per
    round the client and host batch ids and the vote's Laplace noise."""
    dev = g.device

    def disc(lead):
        return {"w1": torch.randn((*lead, d, hidden), generator=g, device=dev) / math.sqrt(d),
                "b1": torch.zeros((*lead, hidden), device=dev),
                "w2": torch.randn((*lead, hidden, 1), generator=g, device=dev) / math.sqrt(hidden),
                "b2": torch.zeros((*lead, 1), device=dev)}

    out = {"teachers": disc((teachers,)), "student": disc(())}
    out["idx"] = torch.randint(0, n, (steps, batch), generator=g, device=dev)
    out["ridx"] = torch.randint(0, n, (steps, batch), generator=g, device=dev)
    out["noise"] = laplace(g, (steps, 2, batch))
    return out
