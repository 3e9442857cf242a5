"""Token data pipeline: tokenizer, synthetic corpus, batching — the port's
own copy of the JAX package's ``data/pipeline.py`` (numpy only; the tests
hold its tokens bit-equal to the JAX package's).

LM training needs a deterministic, dependency-free data
path. ``SyntheticTextDataset`` generates a Zipf-distributed token stream with
local n-gram structure (so a model can actually reduce loss); ``make_batches``
yields host-side numpy batches which the caller moves to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


class ByteTokenizer:
    """Trivial byte-level tokenizer (vocab 256 + specials)."""

    PAD, BOS, EOS = 256, 257, 258
    vocab_size = 259

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        ids = [i for i in np.asarray(ids).tolist() if i < 256]
        return bytes(ids).decode("utf-8", errors="replace")


@dataclass
class SyntheticTextDataset:
    """Zipf tokens with Markov bigram structure — learnable, deterministic."""

    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_order: float = 0.7  # prob of following the bigram table

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse bigram successor table: each token has 4 preferred successors
        self._succ = rng.integers(0, v, size=(min(v, 65536), 4))

    def stream(self, *, seed: Optional[int] = None) -> Iterator[int]:
        rng = np.random.default_rng(self.seed if seed is None else seed)
        v = self.vocab_size
        cur = int(rng.integers(0, v))
        while True:
            yield cur
            if rng.random() < self.markov_order and cur < len(self._succ):
                cur = int(self._succ[cur][rng.integers(0, 4)])
            else:
                # Zipf over the head of the vocab
                cur = int(min(rng.zipf(self.zipf_a), v) - 1)

    def tokens(self, n: int, *, seed: Optional[int] = None) -> np.ndarray:
        it = self.stream(seed=seed)
        return np.fromiter((next(it) for _ in range(n)), dtype=np.int32, count=n)


def make_batches(
    ds: SyntheticTextDataset,
    *,
    batch: int,
    seq_len: int,
    steps: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {tokens, labels} with labels = next-token shift."""
    for step in range(steps):
        toks = ds.tokens(batch * (seq_len + 1), seed=seed * 100_003 + step)
        toks = toks.reshape(batch, seq_len + 1)
        yield {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
