"""Plain PyTorch versions of the hand-written kernels (mirrors ``repro.kernels.ref``).

``kernels.ops`` runs these for CPU tensors; the CPU tests hold them against
``repro``'s references and Pallas kernels, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  Nothing on the main path calls them
for a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import segment
from repro_torch.mapreduce.shuffle import hash_u32


def search_steps(n_rows: int) -> int:
    """Fixed iteration count covering any [lo, hi) bracket within n_rows rows."""
    return max(1, math.ceil(math.log2(max(n_rows, 2)))) + 1


def suffix_windows(tokens: torch.Tensor, sigma: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """All sigma-truncated suffixes of a PAD-separated token stream.

    Returns (windows [N, sigma] int32 zeroed after the first PAD, valid [N]).
    """
    n = tokens.shape[0]
    padded = torch.cat([tokens, tokens.new_zeros(sigma)])
    idx = (torch.arange(n, device=tokens.device)[:, None]
           + torch.arange(sigma, device=tokens.device)[None, :])
    w = padded[idx]
    keep = torch.cumprod((w != 0).to(torch.int32), dim=1)
    return (w * keep).to(torch.int32), tokens != 0


def suffix_pack_ref(tokens: torch.Tensor, *, sigma: int,
                    vocab_size: int) -> torch.Tensor:
    """Packed sigma-truncated suffix lanes [N, n_lanes] int64 of a token stream."""
    windows, _ = suffix_windows(tokens, sigma)
    return packing.pack_terms(windows, vocab_size=vocab_size)


def hash_partition_ref(keys: torch.Tensor, valid: torch.Tensor, n_parts: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids [N] int32 with n_parts for invalid, histogram [n_parts] int32)."""
    p = (hash_u32(keys) % n_parts).to(torch.int32)
    p = torch.where(valid, p, n_parts)
    hist = torch.bincount(p, minlength=n_parts + 1)[:n_parts]
    return p, hist.to(torch.int32)


def lcp_boundary_ref(sorted_terms: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lcp [N] int32, flags [N, L] bool) of a lexicographically sorted matrix."""
    lcp = segment.lcp_lengths(sorted_terms)
    return lcp, segment.boundary_flags(sorted_terms, lcp)


def bsearch_ref(lanes: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, *, upper: bool = False,
                steps: int | None = None) -> torch.Tensor:
    """Batched lexicographic lower (or upper) bound [Q] int32 of packed query
    lanes [Q, L] in sorted lanes [R, L], each within its own [lo, hi).

    A fixed number of branchless halving steps, all queries in lockstep.
    """
    if steps is None:
        steps = search_steps(lanes.shape[0])
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if lanes.shape[0] == 0:
        return lo.to(torch.int32)
    for _ in range(steps):
        mid = (lo + hi) // 2
        rows = lanes[mid.clamp(max=lanes.shape[0] - 1)]     # [Q, L]
        eq = rows == queries
        prefix_eq = torch.cat(
            [torch.ones_like(eq[:, :1]),
             torch.cumprod(eq[:, :-1].to(torch.int32), dim=1).to(torch.bool)],
            dim=1)
        go_right = (prefix_eq & (rows < queries)).any(dim=1)
        if upper:
            go_right = go_right | eq.all(dim=1)
        open_ = lo < hi
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo.to(torch.int32)
