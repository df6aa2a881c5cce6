"""Synthetic recsys batch generators (Criteo-like CTR, behavior sequences,
retrieval pairs), a copy of ``repro.data.recsys``: numpy only, so a batch is
bit for bit ``repro``'s.  Deterministic in (seed, step) like the LM loader."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CTRBatchGen:
    """n_sparse categorical fields with per-field vocab + 13 dense features."""
    field_vocabs: tuple[int, ...]
    n_dense: int = 13
    seed: int = 0

    def batch_at(self, step: int, batch: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        ids = np.stack([rng.zipf(1.2, batch) % v for v in self.field_vocabs], 1)
        return {
            "sparse_ids": ids.astype(np.int32),
            "dense": rng.standard_normal((batch, self.n_dense)).astype(np.float32),
            "labels": (rng.random(batch) < 0.03).astype(np.float32),
        }


@dataclass
class BehaviorSeqGen:
    """User behavior sequences + target item (BST)."""
    item_vocab: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, batch: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        return {
            "history": (rng.zipf(1.3, (batch, self.seq_len)) % self.item_vocab
                        ).astype(np.int32),
            "target": (rng.zipf(1.3, batch) % self.item_vocab).astype(np.int32),
            "labels": (rng.random(batch) < 0.05).astype(np.float32),
        }


@dataclass
class RetrievalGen:
    """(user features, positive item id) pairs for in-batch sampled softmax."""
    item_vocab: int
    user_feat: int
    seed: int = 0

    def batch_at(self, step: int, batch: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        return {
            "user": rng.standard_normal((batch, self.user_feat)).astype(np.float32),
            "pos_item": (rng.zipf(1.3, batch) % self.item_vocab).astype(np.int32),
        }
