"""Packed multi-key lexicographic sort (port of ``repro.mapreduce.sort``).

torch has no ``num_keys`` sort, so the lexicographic order comes from a chain
of stable sorts from the last key to the first.  Two uint32 lanes fuse into
one int64 key, ``(hi - 2**31) * 2**32 + lo``, whose signed order is the
unsigned order of the pair -- so a record of ``K`` key lanes costs
``ceil(K / 2)`` sort passes.  ``repro`` sorts unstably; the port's order is
stable, and every consumer depends only on the contiguity of equal keys.
"""
from __future__ import annotations

import torch

_HALF = 1 << 31
_WORD = 1 << 32


def _fused_keys(keys: torch.Tensor) -> list[torch.Tensor]:
    """Sort keys, most significant first: lane pairs fused into one int64."""
    out = []
    for j in range(0, keys.shape[1], 2):
        if j + 1 < keys.shape[1]:
            out.append((keys[:, j] - _HALF) * _WORD + keys[:, j + 1])
        else:
            out.append(keys[:, j])
    return out


def lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Permutation [N] int64 that sorts rows of ``keys`` [N, K] lexicographically."""
    perm = None
    for k in reversed(_fused_keys(keys)):
        k = k if perm is None else k[perm]
        step = torch.sort(k, stable=True).indices
        perm = step if perm is None else perm[step]
    if perm is None:
        perm = torch.arange(keys.shape[0], device=keys.device)
    return perm


def sort_records(records: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Sort record rows [N, W] lexicographically by their first ``n_keys`` lanes;
    the remaining lanes (weight / meta) ride along."""
    return records[lex_order(records[:, :n_keys])]


def sort_with_payload(keys: torch.Tensor, payloads: list[torch.Tensor]
                      ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Sort [N, K] key matrix lexicographically, carrying payloads [N, ...]."""
    perm = lex_order(keys)
    return keys[perm], [p[perm] for p in payloads]
