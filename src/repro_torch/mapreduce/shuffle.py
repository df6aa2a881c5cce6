"""Shuffle keys and partitioning (port of ``repro.mapreduce.shuffle``).

The paper's partitioner (Algorithm 4) hashes the suffix's first term only, so
all evidence for an n-gram lands on one reducer.  On one device the partition
ids feed the ``shuffle_skew`` counter.  Across ranks (a
:class:`~repro_torch.launch.mesh.DataMesh`), :func:`shuffle` buckets the
records into a fixed-capacity ``[n_parts, capacity, W]`` buffer and
exchanges it with ``all_to_all_single``: the MoE-dispatch pattern ``repro``
runs with ``jax.lax.all_to_all``.  Overflow is counted, never dropped: the
capacity doubles until every (source, destination) pair fits, as ``repro``'s
drivers retry a job with doubled capacity.

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


def bucketize(records: torch.Tensor, part: torch.Tensor, n_parts: int,
              capacity: int, counts: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter records [N, W] into buckets [n_parts, capacity, W].

    ``part`` in [0, n_parts] (n_parts = drop); ``counts``: the records of
    each part [n_parts] when the caller has them (``kops.hash_partition``'s
    histogram).  Records keep their order within a part; a part's records
    past ``capacity`` are left out and counted.  Returns (buffer, overflow
    count as a 0-d tensor); empty slots are all zero (weight 0 marks them
    invalid downstream).
    """
    n, w = records.shape
    dev = records.device
    part = part.to(torch.int64)
    if counts is None:
        counts = torch.zeros(n_parts + 1, dtype=torch.int64, device=dev).index_add_(
            0, part, torch.ones_like(part))[:n_parts]
    counts = counts.to(torch.int64)
    offsets = torch.zeros(n_parts + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=offsets[1:])
    p_s, order = torch.sort(part, stable=True)
    within = torch.arange(n, device=dev) - offsets[p_s]
    ok = (within < capacity) & (p_s < n_parts)
    # every shape fixed by the arguments (no mask-indexed copy): records that
    # do not fit, or go to no part, land in one spare row past the end
    buf = torch.zeros((n_parts * capacity + 1, w), dtype=records.dtype, device=dev)
    buf[torch.where(ok, p_s * capacity + within, n_parts * capacity)] = records[order]
    overflow = (counts - capacity).clamp_(min=0).sum()
    return buf[:-1].view(n_parts, capacity, w), overflow


def exchange(buffer: torch.Tensor, mesh) -> torch.Tensor:
    """all_to_all the bucket buffer [n_parts, capacity, W]: the leading axis
    indexes the destination before, the source after.  Returns this rank's
    records [n_parts * capacity, W]."""
    return mesh.all_to_all(buffer).reshape(-1, buffer.shape[-1])


def fit_capacity(hist: torch.Tensor, capacity: int, mesh, *,
                 max_retries: int = 6, what: str = "shuffle") -> tuple[int, int]:
    """(capacity, retries): ``capacity`` doubled until it holds the largest
    part of every rank (``hist``: this rank's records a part), at most
    ``max_retries - 1`` times.

    The capacity and retry count ``repro`` reaches by running the shuffle,
    reading the overflow ``psum`` and doubling: a run overflows exactly when
    some (source, destination) pair holds more records than the capacity.
    Here one reduction of the largest part decides it before the exchange,
    so no overflowing buffer is ever sent.
    """
    need = mesh.max_int(hist.max() if hist.numel() else 0)
    for attempt in range(max_retries):
        if need <= capacity:
            return capacity, attempt
        capacity *= 2
    raise RuntimeError(f"{what} overflow persisted at capacity {capacity}")


def shuffle(records: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor, *,
            mesh, capacity: int, max_retries: int = 6
            ) -> tuple[torch.Tensor, int, int]:
    """The map-side shuffle across ranks: partition (the ``hash_partition``
    kernel: ``hash_u32(key) % P``, invalid records to the drop bucket) ->
    capacity fit -> bucket -> exchange.

    Returns (this rank's records [P * capacity, W], the capacity used, the
    doublings it took).  Every rank calls it together.
    """
    from repro_torch.kernels import ops as kops
    part, hist = kops.hash_partition(keys, valid, n_parts=mesh.size)
    capacity, retries = fit_capacity(hist, capacity, mesh, max_retries=max_retries)
    buf, _ = bucketize(records, part, mesh.size, capacity, counts=hist)
    return exchange(buf, mesh), capacity, retries
