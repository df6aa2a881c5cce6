"""Sharded, deterministic batch iterators (a copy of ``repro.data.loader``:
numpy only, so a batch is bit for bit ``repro``'s).

Determinism contract (fault tolerance): batch at step s is a pure function of
(seed, step) so a restarted run replays the identical stream without coordination --
the checkpoint stores only the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class LMBatchLoader:
    """Causal-LM batches from a token stream: inputs [B, S], labels shifted by 1."""
    tokens: np.ndarray
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        n = self.tokens.shape[0] - self.seq_len - 1
        starts = rng.integers(0, max(1, n), self.global_batch)
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        window = self.tokens[idx % self.tokens.shape[0]]
        return {"tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class SyntheticLMLoader:
    """Shape-only loader for dry runs / perf smoke: random ids, zero host IO."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        t = rng.integers(1, self.vocab_size, (self.global_batch, self.seq_len + 1))
        return {"tokens": t[:, :-1].astype(np.int32),
                "labels": t[:, 1:].astype(np.int32)}
