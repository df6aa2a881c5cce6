"""Shared stage implementations of the map/combine/shuffle/sort/reduce pipeline
(port of the main-path parts of ``repro.pipeline.stages``).

  combine -- map-side pre-aggregation (the Hadoop combiner).  Two routes:
             ``"sort"`` (sort + run-merge, exact within the buffer) and
             ``"hash"`` (the sort-free hash-slot pass of the ``hash_combine``
             kernel: best-effort per 256-row block, exact in total weight).
  shuffle -- partition-key computation (``mapreduce.shuffle.record_key``).
  sort    -- multi-key lexicographic sort of the packed lanes.
  reduce  -- ``reduce_suffix``: LCP runs, every prefix of every suffix
             (Algorithm 4), through the ``lcp_boundary`` kernel;
             ``reduce_exact``: whole-gram runs (NAIVE, APRIORI-SCAN/-INDEX).
  collect -- ``segment_candidates``: a reducer's kept cells as packed
             segment rows, the wave engine's collect on the device.

Records are ``[N, W]`` int64 (packed lanes | weight | meta, where the meta
lane is a position or a time-series bucket); shapes stay static, and token
id 0 reads as "no token" throughout, as in ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import segment, shuffle, sort


# ------------------------------------------------------------------- combine
def _keys(records: torch.Tensor, n_lanes: int, has_bucket: bool) -> torch.Tensor:
    """The combiner's key: the packed lanes (a view), or with a bucket lane
    the lanes and the bucket, which the weight column parts, gathered into
    one matrix, so that series buckets stay apart.  Of the gathers measured
    on the card, indexing with a column list was the fastest (``torch.cat``
    of the two slices and ``index_select`` ran slower)."""
    if has_bucket:
        return records[:, list(range(n_lanes)) + [n_lanes + 1]]
    return records[:, :n_lanes]


def combine_sort(records: torch.Tensor, n_lanes: int,
                 has_bucket: bool = False) -> torch.Tensor:
    """Sort-based map-side combiner: merge records with identical keys.

    Keys are the packed lanes, plus the bucket lane if present.  Non-first
    rows of each run get weight 0 (dropped by the shuffle's validity mask);
    shapes stay static.  The records keep their layout, lanes | weight |
    (bucket): the sort reads the key columns, and the rows move whole.
    """
    rec = records[sort.lex_order(_keys(records, n_lanes, has_bucket))]
    keys = _keys(rec, n_lanes, has_bucket)
    first = (keys != torch.roll(keys, 1, dims=0)).any(dim=1)
    first[:1] = True
    seg = torch.cumsum(first, dim=0) - 1
    weight = rec[:, n_lanes]
    wsum = torch.zeros_like(weight).index_add_(0, seg, weight)
    rec[:, n_lanes] = torch.where(first, wsum[seg], 0)
    return rec


def combine_hash(records: torch.Tensor, n_lanes: int, has_bucket: bool = False, *,
                 block: int = 256) -> torch.Tensor:
    """Sort-free hash-slot combiner: collapse duplicate keys without a sort.

    Per block of ``block`` records (and ``2 * block`` slots, as ``repro``:
    the ``shuffle_*`` counters count what survives, so the rule must match),
    rows whose key equals their slot winner's key donate their weight to the
    winner; slot losers keep theirs.  Row order never changes.  The weight
    lane is rewritten in place by the one kernel launch (``out=`` the weight
    column): the records are the emit's own buffer.  Keys are the lanes,
    read in place, or with a bucket lane a gathered lanes | bucket matrix
    (which ``hash_combine`` takes to its generic instance).
    """
    weights = records[:, n_lanes]
    kops.hash_combine(_keys(records, n_lanes, has_bucket), weights, block=block,
                      out=weights)
    return records


def combine(records: torch.Tensor, n_lanes: int, has_bucket: bool = False, *,
            route: str = "sort") -> torch.Tensor:
    if route == "sort":
        return combine_sort(records, n_lanes, has_bucket)
    if route == "hash":
        return combine_hash(records, n_lanes, has_bucket)
    raise ValueError(f"unknown combine route {route!r}")


# ------------------------------------------------------------------- shuffle
def partition_keys(records: torch.Tensor, n_lanes: int, *, kind: str,
                   vocab_size: int) -> torch.Tensor:
    """Per-record shuffle key (uint32 values) from the packed gram lanes."""
    return shuffle.record_key(records[:, :n_lanes], kind=kind,
                              vocab_size=vocab_size)


# -------------------------------------------------------------- sort + reduce
def sort_stage(records: torch.Tensor, *, n_keys: int) -> torch.Tensor:
    """The MapReduce sort phase: lexicographic on the first ``n_keys`` lanes."""
    return sort.sort_records(records, n_keys=n_keys)


def reduce_suffix(rec: torch.Tensor, *, sigma: int, vocab_size: int,
                  n_buckets: int = 0):
    """LCP-run reducer over a *sorted* record block (SUFFIX-sigma).

    rec: [N, W] sorted = lanes | weight | (bucket).  Returns (terms [N, sigma]
    int32, flags [N, sigma] bool, counts [N, sigma] int32, or [N, sigma, B]
    per-bucket totals with ``n_buckets = B``).
    """
    n_l = packing.n_lanes(sigma, vocab_size)
    terms = packing.unpack_terms(rec[:, :n_l], vocab_size=vocab_size,
                                 sigma=sigma)
    _, flags = kops.lcp_boundary(terms)
    if n_buckets:
        counts = segment.run_counts_matrix(flags, terms != 0, rec[:, n_l],
                                           rec[:, n_l + 1], n_buckets,
                                           max_segments=rec.shape[0])
    else:
        counts = segment.run_counts(flags, terms != 0, rec[:, n_l],
                                    max_segments=rec.shape[0])
    return terms, flags, counts


def reduce_exact(rec: torch.Tensor, *, sigma: int, vocab_size: int,
                 with_positions: bool = False, n_positions: int | None = None):
    """Whole-gram reducer over a *sorted* record block (NAIVE / APRIORI-*).

    rec: [N, W] sorted = lanes | weight | (pos).  Returns (terms, flags,
    counts) shaped like :func:`reduce_suffix`; flags mark the first row of
    each run at the row's own gram length.  With ``with_positions`` it also
    returns the run total of every position [n_positions] int32 (default
    N), scattered back through the position lane of the valid rows (the
    APRIORI-INDEX posting-list join); a position no valid row holds gets 0.
    Valid rows hold distinct positions, so the scatter writes each index
    once.
    """
    n = rec.shape[0]
    n_l = packing.n_lanes(sigma, vocab_size)
    lanes = rec[:, :n_l]
    weight = rec[:, n_l].to(torch.int32)
    terms = packing.unpack_terms(lanes, vocab_size=vocab_size, sigma=sigma)

    first = (lanes != torch.roll(lanes, 1, dims=0)).any(dim=1)
    first[:1] = True
    seg = (torch.cumsum(first, dim=0) - 1).clamp_(min=0)
    totals = torch.zeros(n, dtype=torch.int32, device=rec.device)
    totals = totals.index_add_(0, seg, weight)[seg]

    length = (terms != 0).sum(dim=1)                   # gram length per row
    row_flags = first & (length > 0) & (weight >= 0) & (totals > 0)
    slot = torch.arange(sigma, device=rec.device)
    flags = (slot[None, :] == (length - 1)[:, None]) & row_flags[:, None]
    counts = flags * totals[:, None]
    if not with_positions:
        return terms, flags, counts
    size = n if n_positions is None else n_positions
    totals_at_pos = torch.zeros(size + 1, dtype=torch.int32, device=rec.device)
    totals_at_pos[torch.where(weight > 0, rec[:, n_l + 1], size)] = totals
    return terms, flags, counts, totals_at_pos[:size]


# ------------------------------------------------- device-side segment collect
def segment_candidates(flags: torch.Tensor, counts: torch.Tensor,
                       lanes: torch.Tensor, masks: torch.Tensor, *, sigma: int,
                       reduce_kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed segment-candidate rows straight off a reducer's dense output.

    A kept cell (flag set, count >= 1) of length ``l`` has segment key
    ``(l | lanes & masks[l])``: zeroing a term slot's bit field packs PAD
    there (``mapreduce.pack.prefix_lane_masks``), so the table is an
    elementwise function of (flags, counts, the sorted key lanes).  Returns
    (keys [M, 1 + n_lanes], counts [M]) int64 with dead rows zeroed (length
    0, count 0): ``"suffix"`` reducers may keep several lengths a row, so M =
    N * sigma (row r, length l at r * sigma + l - 1); ``"exact"`` reducers
    keep at most one (the row's own gram length), so M = N.  Within one wave
    every kept key is unique, so a sort of the kept rows orders them as a
    pure function of the row set.
    """
    n, n_l = lanes.shape
    keep = flags & (counts >= 1)
    if reduce_kind == "suffix":
        keys = torch.empty((n, sigma, 1 + n_l), dtype=torch.int64,
                           device=lanes.device)
        torch.bitwise_and(lanes[:, None, :], masks[None, 1:], out=keys[:, :, 1:])
        keys[:, :, 0] = torch.arange(1, sigma + 1, device=lanes.device)
        keys *= keep[:, :, None]
        cnts = counts.to(torch.int64) * keep
        return keys.view(n * sigma, 1 + n_l), cnts.view(n * sigma)
    # exact: at most one flagged length a row -- no sigma blowup
    len_idx = keep.to(torch.uint8).argmax(dim=1)             # 0 when dead
    keep_row = keep.any(dim=1)
    length = (len_idx + 1) * keep_row
    keys = torch.empty((n, 1 + n_l), dtype=torch.int64, device=lanes.device)
    keys[:, 0] = length
    torch.bitwise_and(lanes, masks[length], out=keys[:, 1:])
    cnts = counts.gather(1, len_idx[:, None]).squeeze(1).to(torch.int64) * keep_row
    return keys, cnts


# ----------------------------------------------------------- canonical output
def canonical_stats(stats):
    """Canonical row order + dedup of a job output: sort by (length, terms
    lexicographic) and sum counts of identical grams -- the order an
    ``IndexSegment`` stores.  Host-side numpy, as in ``repro``."""
    from repro_torch.core.stats import NGramStats
    grams = np.asarray(stats.grams, np.int32)
    lengths = np.asarray(stats.lengths, np.int32)
    counts = np.asarray(stats.counts)
    r, sigma = grams.shape
    if r == 0:
        return NGramStats(grams, lengths,
                          counts.astype(np.int64), dict(stats.counters))
    # np.lexsort: last key is primary -> (length, g[:,0], ..., g[:,sigma-1])
    order = np.lexsort(tuple(grams[:, i] for i in range(sigma - 1, -1, -1))
                       + (lengths,))
    g_s, l_s, c_s = grams[order], lengths[order], counts[order]
    prev_diff = np.any(g_s != np.roll(g_s, 1, axis=0), axis=1) | \
        (l_s != np.roll(l_s, 1))
    prev_diff[0] = True
    starts = np.flatnonzero(prev_diff)
    if len(starts) == r:                  # every gram once (a job's output)
        return NGramStats(g_s, l_s, c_s.astype(np.int64), dict(stats.counters))
    summed = np.add.reduceat(c_s.astype(np.int64), starts, axis=0)
    return NGramStats(g_s[starts], l_s[starts], summed, dict(stats.counters))
