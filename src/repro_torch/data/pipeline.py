"""Synthetic LM data pipeline: the JAX package's ``data/pipeline.py``,
copied as it is (numpy only), so that one seed gives both packages the
same batches bit for bit.

Deterministic, seeded token streams with enough structure that a ~100M
model's loss visibly drops in a few hundred steps:
a periodic Markov-ish source over a reduced symbol set embedded in the full
vocab, packed into fixed-length sequences with next-token labels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    n_symbols: int = 256          # active symbol subset
    order: int = 2                # markov order
    seed: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.n_symbols, cfg.vocab_size)
        self.symbols = rng.choice(cfg.vocab_size, size=k, replace=False)
        # sparse transition table: each (prev, prev2) context prefers ~4 nexts
        self.table = rng.integers(0, k, size=(k, k, 4))
        self._rng = rng

    def _sample_stream(self, n: int, rng) -> np.ndarray:
        k = len(self.symbols)
        out = np.empty(n, np.int64)
        a, b = rng.integers(0, k), rng.integers(0, k)
        for i in range(n):
            choices = self.table[a, b]
            c = choices[rng.integers(0, 4)] if rng.random() < 0.9 \
                else rng.integers(0, k)
            out[i] = c
            a, b = b, c
        return self.symbols[out]

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        n = cfg.seq_len + 1
        while True:
            toks = np.stack([self._sample_stream(n, self._rng)
                             for _ in range(cfg.batch_size)])
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}
