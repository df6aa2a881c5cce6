"""Shuffle keys and partitioning (port of ``repro.mapreduce.shuffle``).

The paper's partitioner (Algorithm 4) hashes the suffix's first term only, so
all evidence for an n-gram lands on one reducer.  On one device the partition
ids feed the ``shuffle_skew`` counter.  ``bucketize`` and the mesh exchange
wait for the multi-device slice.

Hashes are uint32 values in int64 tensors.  Each uint32 product is formed
from 16-bit halves of the constant, so no int64 product ever overflows.
"""
from __future__ import annotations

import torch

from repro_torch import U32
from repro_torch.mapreduce import pack as packing

KNUTH = 2654435761
MIX = 2246822519
GOLDEN = 0x9E3779B9


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(x * k) mod 2**32`` for x in [0, 2**32), without int64 overflow."""
    lo = x * (k & 0xFFFF)                       # < 2**48
    hi = ((x * (k >> 16)) & 0xFFFF) << 16       # < 2**32
    return (lo + hi) & U32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Multiplicative hashing (Knuth) with an xorshift finalizer."""
    h = _mul_u32(x.to(torch.int64) & U32, KNUTH)
    h = h ^ (h >> 15)
    h = _mul_u32(h, MIX)
    return h ^ (h >> 13)


def fold_hash(lanes: torch.Tensor) -> torch.Tensor:
    """Order-sensitive fold hash of packed key lanes [..., L] -> uint32 values."""
    h = torch.zeros(lanes.shape[:-1], dtype=torch.int64, device=lanes.device)
    for i in range(lanes.shape[-1]):
        h = hash_u32(h ^ ((lanes[..., i] + GOLDEN) & U32))
    return h


def record_key(lanes: torch.Tensor, *, kind: str, vocab_size: int) -> torch.Tensor:
    """Partition key of packed gram lanes [..., L]: ``"gram"`` hashes the whole
    record, ``"lead"`` routes by the first term only."""
    if kind == "gram":
        return fold_hash(lanes)
    if kind == "lead":
        return packing.lead_term(lanes[..., 0], vocab_size=vocab_size)
    raise ValueError(f"unknown partition key kind {kind!r}")


def partition_ids(keys: torch.Tensor, valid: torch.Tensor,
                  n_parts: int) -> torch.Tensor:
    """Reducer id per record (int32); invalid records go to bucket ``n_parts``."""
    p = (hash_u32(keys) % n_parts).to(torch.int32)
    return torch.where(valid, p, n_parts)
