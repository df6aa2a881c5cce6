"""Shared row-layout constants and helpers of the index (port of
``repro.index._layout``): sentinel-padded sorted rows, a bucketed first-term
fanout grid, and 128-row capacity quanta."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import U32

MAX_FANOUT = 4096   # fanout table columns per length section (memory/probe trade)
SENTINEL = U32      # pad rows: uint32 all-ones, sorts after every real row
PAD_QUANTUM = 128   # row capacities round up to this (shards/segments stack)


def fanout_layout(vocab_size: int) -> tuple[int, int]:
    """(shift, n_buckets): lead term t maps to bucket t >> shift, monotonically."""
    shift = 0
    while ((vocab_size + 1) >> shift) > MAX_FANOUT:
        shift += 1
    n_buckets = ((vocab_size + 1) >> shift) + 1
    return shift, n_buckets


def round_capacity(n_rows: int) -> int:
    """Default padded capacity for ``n_rows`` real rows (+1 sentinel guard)."""
    return max(PAD_QUANTUM, -(-(n_rows + 1) // PAD_QUANTUM) * PAD_QUANTUM)


def pad_rows(a: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Pad dim 0 of ``a`` to ``size`` rows with ``fill``."""
    out = a.new_full((size,) + tuple(a.shape[1:]), fill)
    out[:a.shape[0]] = a
    return out


def row_offsets(sorted_key: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Lower-bound offsets of ``queries`` in a sorted key column, int32."""
    return torch.searchsorted(sorted_key, queries, side="left").to(torch.int32)


def row_lengths(section_start: torch.Tensor, size: int) -> torch.Tensor:
    """Row length 1..sigma (sentinels: sigma+1) [size] int32 from the section
    start table."""
    rows = torch.arange(size, dtype=section_start.dtype, device=section_start.device)
    return torch.searchsorted(section_start, rows, side="right").to(torch.int32)


def row_bytes_view(keys: np.ndarray) -> np.ndarray:
    """[N] void view of uint32 key rows whose byte order is the numeric
    lexicographic order (big-endian bytes), for host sorts and merges."""
    n_cols = keys.shape[1]
    return np.ascontiguousarray(keys.astype(">u4")).view(
        np.dtype((np.void, 4 * n_cols)))[:, 0]
