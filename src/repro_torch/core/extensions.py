"""SSVI-A extensions of SUFFIX-sigma: maximal and closed n-grams (port of
``repro.core.extensions``).

Maximality needs only one-term extensions (the paper's two-stage scheme): r
is maximal iff no frequent r||<x> (right extension) and no frequent <y>||r
(left extension) -- any longer frequent supersequence implies a frequent
one-term extension by the APRIORI principle.  Stage 1 filters right
extensions on the forward grams ("prefix-maximal"); stage 2 filters left
extensions by running the same filter on the *reversed* survivors (the
paper's post-filtering job).  Closedness is the same with the extra
cf-equality condition.

The filter reuses the job's sort + run machinery on the device: after the
sort, the strings extending r form the run of r's own prefix, so "a
frequent extension exists" is "r's run at level |r| holds a longer row"
(closed: "... with equal cf").  ``jax.ops.segment_max`` becomes
``scatter_reduce_(..., "amax")``.  The result is host ``NGramStats``.

Document-frequency aggregation over SUFFIX-sigma's single pass is not
provided, as in ``repro``: distinct (prefix, doc) pairs are not contiguous
below the full sort key.  ``aggregations`` has the one-job whole-gram df and
the per-length variant.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import segment, sort
from .stats import NGramStats

__all__ = ["filter_stats"]


def _segment_max(values: torch.Tensor, seg: torch.Tensor, m: int) -> torch.Tensor:
    """Max of ``values`` over each segment id in ``seg`` ([m] slots; a slot
    no row names keeps 0 and is never read)."""
    return values.new_zeros(m).scatter_reduce_(0, seg, values, "amax",
                                               include_self=False)


def _prefix_extension_filter(grams: np.ndarray, lengths: np.ndarray,
                             counts: np.ndarray, closed: bool,
                             device=None) -> np.ndarray:
    """Keep mask [R] over rows: False where some other row extends the row's
    gram to the right (closed: with equal count).  Rows must be distinct
    grams.  Sorts and scans on ``device`` (the card unless told otherwise)."""
    m, sigma = grams.shape
    if m == 0:
        return np.zeros((0,), bool)
    dev = resolve_device(device)
    vocab = max(1, int(grams.max()))
    lanes = packing.pack_terms(torch.as_tensor(grams, device=dev), vocab_size=vocab)
    keys, (lens_s, counts_s, orig) = sort.sort_with_payload(
        lanes, [torch.as_tensor(lengths, device=dev).to(torch.int32),
                torch.as_tensor(counts, device=dev).to(torch.int64),
                torch.arange(m, device=dev)])
    terms = packing.unpack_terms(keys, vocab_size=vocab, sigma=sigma)
    lcp = segment.lcp_lengths(terms)
    first = torch.arange(m, device=dev) == 0

    keep = torch.ones(m, dtype=torch.bool, device=dev)
    for level in range(1, sigma + 1):
        at_level = lens_s == level
        # runs of the level-prefix among rows with length >= level
        valid = lens_s >= level
        new_run = valid & ((lcp < level) | first)
        seg = (torch.cumsum(new_run, dim=0) - 1).clamp_(min=0)
        longer = valid & (lens_s > level)
        if closed:
            own = torch.where(at_level, counts_s, -1)
            hit = longer & (counts_s == _segment_max(own, seg, m)[seg])   # cf of r itself
        else:
            hit = longer
        run_hit = _segment_max(hit.to(torch.int32), seg, m)
        keep &= ~(at_level & (run_hit[seg] > 0) & valid)
    out = torch.ones(m, dtype=torch.bool, device=dev)
    out[orig] = keep
    return out.cpu().numpy()


def _reverse_grams(grams: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Each gram's first ``length`` terms reversed, PAD after them."""
    sigma = grams.shape[1]
    j = np.arange(sigma)[None, :]
    ln = np.asarray(lengths)[:, None]
    src = np.where(j < ln, ln - 1 - j, j)
    rev = np.take_along_axis(grams, src, axis=1)
    return np.where(j < ln, rev, 0).astype(grams.dtype)


def filter_stats(stats: NGramStats, mode: str, *, device=None) -> NGramStats:
    """Restrict job output to maximal or closed n-grams (``mode`` in {"max",
    "closed"}).  A series job's rows are filtered by their summed counts and
    keep their series.  Both stages run on ``device``, the card unless told
    otherwise; the result is host ``NGramStats`` with the counter
    ``post_filter_jobs = 1`` (the paper's extra MapReduce job)."""
    closed = mode == "closed"
    grams, lengths = stats.grams, stats.lengths
    counts = stats.counts.sum(axis=-1) if stats.counts.ndim == 2 else stats.counts
    keep1 = _prefix_extension_filter(grams, lengths, counts, closed, device)
    g1, l1, c1 = grams[keep1], lengths[keep1], stats.counts[keep1]
    flat1 = counts[keep1]
    rev = _reverse_grams(g1, l1)
    keep2 = _prefix_extension_filter(rev, l1, flat1, closed, device)
    counters = dict(stats.counters)
    counters["post_filter_jobs"] = 1
    return NGramStats(g1[keep2], l1[keep2], c1[keep2], counters)
