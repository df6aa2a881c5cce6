"""Segmented run utilities (port of ``repro.mapreduce.segment``).

On a lexicographically sorted block of suffixes every distinct prefix occupies
a contiguous run, so the paper's "pop the stack and emit a count" becomes
"detect a run boundary and segment-sum the weights".  ``run_counts`` does all
sigma lengths in one ``index_add_`` by offsetting length ``l``'s segment ids
by ``l * N``.  ``run_counts_matrix`` (the per-bucket time series of SSVI-B)
takes one length at a time instead: its output alone is [N, L, B], so an
all-lengths pass would hold several tensors of that size at once.

Correctness note: at prefix length l, a row whose suffix is shorter than l
(PAD at position l-1) must not contribute to any length-l run, hence the
explicit ``valid`` mask.
"""
from __future__ import annotations

import torch


def lcp_lengths(sorted_terms: torch.Tensor) -> torch.Tensor:
    """Longest-common-prefix length [N] int32 of each row with the previous row;
    row 0 gets 0."""
    prev = torch.roll(sorted_terms, 1, dims=0)
    eq = (sorted_terms == prev).to(torch.int32)
    lcp = torch.cumprod(eq, dim=1).sum(dim=1, dtype=torch.int32)
    if lcp.numel():
        lcp[0] = 0
    return lcp


def boundary_flags(sorted_terms: torch.Tensor, lcp: torch.Tensor) -> torch.Tensor:
    """flags [N, L]: the length-l prefix of row i starts a new run (and the row
    has length >= l, i.e. no PAD at l-1)."""
    lengths = torch.arange(1, sorted_terms.shape[1] + 1, dtype=torch.int32,
                           device=sorted_terms.device)
    return (lcp[:, None] < lengths[None, :]) & (sorted_terms != 0)


def run_counts(flags: torch.Tensor, valid: torch.Tensor, weights: torch.Tensor,
               max_segments: int) -> torch.Tensor:
    """Per-(row, length) run totals [N, L] int32: at boundary positions, the
    total weight of the run (the collection frequency of that prefix); 0
    elsewhere.  ``max_segments`` bounds the run ids of each length."""
    # run ids from ONE flat scan over the [L, N] transpose, rebased per
    # length: CUDA scans a long 1-D array far faster than a few long rows
    # (innermost dim) or a column-wise scan down dim 0 of [N, L]
    flags_t = flags.t().contiguous()
    length, n = flags_t.shape
    flat = torch.cumsum(flags_t.reshape(-1), dim=0).reshape(length, n)
    base = torch.cat([flat.new_zeros(1), flat[:-1, -1]]) if n else flat.new_zeros(length)
    seg = (flat - base[:, None] - 1).clamp_(min=0)               # [L, N] run ids
    seg += torch.arange(length, device=flags.device)[:, None] * max_segments
    contrib = torch.where(valid.t(), weights.to(torch.int32)[None, :], 0)
    totals = torch.zeros(length * max_segments, dtype=torch.int32,
                         device=flags.device)
    totals.index_add_(0, seg.reshape(-1), contrib.reshape(-1))
    return torch.where(flags_t, totals[seg], 0).t().contiguous()


def run_counts_matrix(flags: torch.Tensor, valid: torch.Tensor,
                      weights: torch.Tensor, buckets: torch.Tensor, n_buckets: int,
                      max_segments: int) -> torch.Tensor:
    """Per-(row, length, bucket) run totals [N, L, B] int32: ``run_counts``
    with each row's weight counted in its bucket alone (``repro``'s
    ``run_counts_matrix`` over one-hot bucketed weights).

    ``buckets`` [N] holds uint32 values; a row whose bucket is not in
    ``[0, n_buckets)`` contributes nothing, as its all-zero one-hot row does
    in ``repro``.  One length at a time, the totals of (run, bucket) are one
    ``index_add_`` at ``run * B + bucket``: no [N, B] one-hot matrix, and one
    [max_segments, B] transient a length.  The result is an [L, N, B] tensor
    seen as [N, L, B].
    """
    n, length = flags.shape
    b = n_buckets
    in_range = buckets < b
    bucket = torch.where(in_range, buckets, 0)
    w = torch.where(in_range, weights, 0).to(torch.int32)
    out = torch.empty((length, n, b), dtype=torch.int32, device=flags.device)
    totals = torch.empty(max_segments * b, dtype=torch.int32, device=flags.device)
    for l in range(length):
        fl = flags[:, l]
        seg = (torch.cumsum(fl, dim=0) - 1).clamp_(min=0)        # [N] run ids
        contrib = torch.where(valid[:, l], w, 0)
        totals.zero_().index_add_(0, seg * b + bucket, contrib)
        torch.index_select(totals.view(max_segments, b), 0, seg, out=out[l])
        out[l] *= fl[:, None]
    return out.permute(1, 0, 2)
