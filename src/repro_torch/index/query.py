"""Batched queries against the port's index layouts (port of
``repro.index.query``).

Flat :class:`~repro_torch.index.build.NGramIndex`, both views:

  1. length + lead-term bucket -> [lo, hi) bracket from the fanout table;
  2. lexicographic lower/upper bound on the packed lanes inside the bracket,
     through the ``bsearch`` kernel (its plain version on a CPU index);
  3. gather counts / top-k continuation rows at the found positions.

Compressed :class:`~repro_torch.index.compress.CompressedNGramIndex`:

  1. the (length, lead bucket) cell's first block from the decoded fanout
     cache, and the index's widest cell (``head_span``) as the bracket;
  2. the same ``bsearch`` over the per-block dense head keys;
  3. the candidate block decoded and ranked in one pass (``block_decode``):
     position = block * block_size + in-block rank;
  4. counts / continuation rows read from the fixed-width bit streams.

:class:`~repro_torch.index.merge.GenerationalIndex`: a point lookup sums cf
over the live segments; top-k fetches every segment's complete continuation
set of each prefix (the whole batch at the widest prefix's width) and folds
them exactly.

Misses and invalid queries resolve to count 0 / empty completion lists
through masks.  A query gram must have 1 <= len <= sigma, all terms in
1..vocab before the PAD tail, and nothing after it; continuation prefixes
allow len 0 (top-k unigrams).  Answers are int64 tensors of uint32 values on
the index's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import U32
from repro_torch.kernels import ops as kops
from repro_torch.kernels.bitpack import extract_bits
from repro_torch.mapreduce import pack as packing
from .build import NGramIndex, search_steps
from .compress import CompressedNGramIndex, head_key_layout
from .merge import GenerationalIndex, merge_continuation_results


def _on(idx, x) -> torch.Tensor:
    """Query input as a tensor on the index's device."""
    if isinstance(x, torch.Tensor):
        return x.to(idx.device)
    return torch.as_tensor(np.asarray(x), device=idx.device)


def _bracket(idx: NGramIndex, table: torch.Tensor, length: torch.Tensor,
             lead: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[lo, hi) rows of the (length, lead-term bucket) fanout cell."""
    sec = (length - 1).clamp(0, idx.sigma - 1).to(torch.int64)
    b = (lead >> idx.fanout_shift).clamp(0, idx.n_fanout - 1)
    return table[sec, b], table[sec, b + 1]


def _clean(idx, grams: torch.Tensor, lengths: torch.Tensor,
           lo_len: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masked grams, lengths, valid): zero the PAD tail, validate term ranges."""
    grams = grams.to(torch.int32)
    lengths = lengths.to(torch.int32)
    in_len = (torch.arange(idx.sigma, dtype=torch.int32, device=grams.device)[None, :]
              < lengths[:, None])
    grams = grams * in_len
    ok_terms = torch.where(in_len, (grams >= 1) & (grams <= idx.vocab_size),
                           True).all(dim=1)
    valid = (lengths >= lo_len) & (lengths <= idx.sigma) & ok_terms
    return grams, lengths, valid


# --------------------------------------------------------------------------- #
# compressed plan: head bracket -> head bsearch -> block decode -> gather
# --------------------------------------------------------------------------- #

def _dense_qkey(cidx: CompressedNGramIndex, length: torch.Tensor,
                terms: torch.Tensor) -> torch.Tensor:
    """[Q, HL] int64 query keys in the dense head layout (the query side of
    ``compress._pack_head_keys``: (length, t0..t_{sigma-1}) MSB-first).
    Garbage terms of invalid queries stay in-width and are discarded
    downstream."""
    fields, hl = head_key_layout(cidx.sigma, cidx.term_bits)
    cols = [length] + [terms[:, j] for j in range(cidx.sigma)]
    out = [torch.zeros(length.shape, dtype=torch.int64, device=length.device)
           for _ in range(hl)]
    for (o, w), v in zip(fields, cols):
        v = v.to(torch.int64) & ((1 << w) - 1)
        r = o + w
        j0 = o // 32
        e0 = 32 * (j0 + 1)
        if r <= e0:
            out[j0] = out[j0] | ((v << (e0 - r)) & U32)
        else:                       # field straddles a lane boundary
            out[j0] = out[j0] | (v >> (r - e0))
            e1 = 32 * ((r - 1) // 32 + 1)
            out[(r - 1) // 32] = out[(r - 1) // 32] | ((v << (e1 - r)) & U32)
    return torch.stack(out, dim=1)


def _c_head_bracket(cidx: CompressedNGramIndex, table: torch.Tensor,
                    length: torch.Tensor, lead: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[lo_h, hi_h) *block* bracket of the (length, lead-term bucket) cell:
    the cell's first block from the decoded fanout cache, capped at the
    widest cell (``head_span``).  Ranks count against the global (length,
    terms) order, so rows outside the cell still compare consistently."""
    sec = (length - 1).clamp(0, cidx.sigma - 1).to(torch.int64)
    b = (lead >> cidx.fanout_shift).clamp(0, cidx.n_fanout - 1)
    lo_h = table[sec * (cidx.n_fanout + 1) + b]
    return lo_h, (lo_h + cidx.head_span).clamp(max=cidx.n_blocks)


def _c_rank(cidx: CompressedNGramIndex, blk: torch.Tensor, q_terms: torch.Tensor,
            q_len: torch.Tensor, *, cont: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(cnt_lt, cnt_eq) of each query inside its candidate block."""
    if cont:
        args = (cidx.cont_lcps, cidx.cont_payload, cidx.cont_block_base)
    else:
        args = (cidx.lcps, cidx.payload, cidx.block_base)
    return kops.block_decode(*args, cidx.sec_cache, blk.to(torch.int32),
                             q_terms.to(torch.int32), q_len.to(torch.int32),
                             term_bits=cidx.term_bits, lcp_width=cidx.lcp_width,
                             block_size=cidx.block_size, len_off=int(cont))


def _terms_of(cidx, lanes: torch.Tensor, terms: torch.Tensor | None) -> torch.Tensor:
    if terms is None:
        # pre-packed callers: recover the terms (exact for valid rows)
        terms = packing.unpack_terms(lanes, vocab_size=cidx.vocab_size,
                                     sigma=cidx.sigma)
    return terms


def _c_lookup_packed(cidx: CompressedNGramIndex, q_lanes: torch.Tensor,
                     q_len: torch.Tensor, valid: torch.Tensor, *,
                     q_terms: torch.Tensor | None = None) -> torch.Tensor:
    b, nb = cidx.block_size, cidx.n_blocks
    q_terms = _terms_of(cidx, q_lanes, q_terms)
    qkey = _dense_qkey(cidx, q_len, q_terms)
    # point rows are unique, so the block holding q (if any) is the last one
    # whose head <= q: the upper bound over heads, minus one
    lead = packing.lead_term(q_lanes[:, 0], vocab_size=cidx.vocab_size)
    lo_h, hi_h = _c_head_bracket(cidx, cidx.fan_cache, q_len, lead)
    pos_h = kops.bsearch(cidx.head_lanes, qkey, lo_h, hi_h, upper=True,
                         steps=cidx.head_steps)
    blk = (pos_h.to(torch.int64) - 1).clamp(0, nb - 1)
    cnt_lt, cnt_eq = _c_rank(cidx, blk, q_terms, q_len, cont=False)
    pos = (blk * b + cnt_lt).clamp(0, cidx.size - 1)
    hit = valid & (cnt_eq > 0)        # uniqueness makes equality self-validating
    cf = extract_bits(cidx.counts_packed, pos, cidx.count_width)
    return torch.where(hit, cf, 0)


def _c_continuations_packed(cidx: CompressedNGramIndex, p_lanes: torch.Tensor,
                            p_len: torch.Tensor, valid: torch.Tensor, *, k: int,
                            p_terms: torch.Tensor | None = None):
    b, nb = cidx.block_size, cidx.n_blocks
    lead = packing.lead_term(p_lanes[:, 0], vocab_size=cidx.vocab_size)
    target = p_len + 1
    lo_h, hi_h = _c_head_bracket(cidx, cidx.cont_fan_cache, target, lead)
    p_terms = _terms_of(cidx, p_lanes, p_terms)
    qkey = _dense_qkey(cidx, target, p_terms)
    # duplicate prefixes can straddle blocks: the lower bound needs the block
    # before the first head >= q, the upper bound the block of the last head <= q
    m_lb = kops.bsearch(cidx.cont_head_lanes, qkey, lo_h, hi_h, upper=False,
                        steps=cidx.head_steps)
    m_ub = kops.bsearch(cidx.cont_head_lanes, qkey, lo_h, hi_h, upper=True,
                        steps=cidx.head_steps)
    blk_lb = (m_lb.to(torch.int64) - 1).clamp(0, nb - 1)
    blk_ub = (m_ub.to(torch.int64) - 1).clamp(0, nb - 1)
    # one rank call for both bounds (doubled batch)
    nq = blk_lb.shape[0]
    lt2, eq2 = _c_rank(cidx, torch.cat([blk_lb, blk_ub]),
                       torch.cat([p_terms, p_terms]), torch.cat([target, target]),
                       cont=True)
    lb = torch.where(valid, blk_lb * b + lt2[:nq], 0)
    ub = torch.where(valid, blk_ub * b + lt2[nq:] + eq2[nq:], 0)
    n_distinct = ub - lb
    total = cidx.cumsum_cache[ub] - cidx.cumsum_cache[lb]
    offs = lb[:, None] + torch.arange(k, device=lb.device)[None, :]
    in_group = offs < ub[:, None]
    safe = offs.clamp(max=cidx.size - 1)
    terms = torch.where(in_group, extract_bits(cidx.cont_last_packed, safe,
                                               cidx.term_bits), 0)
    counts = torch.where(in_group, extract_bits(cidx.cont_counts_packed, safe,
                                                cidx.count_width), 0)
    return n_distinct, total, terms, counts


# --------------------------------------------------------------------------- #
# single-index entry points (either layout)
# --------------------------------------------------------------------------- #

def lookup_packed(idx, q_lanes: torch.Tensor, q_len: torch.Tensor,
                  valid: torch.Tensor, *,
                  q_terms: torch.Tensor | None = None) -> torch.Tensor:
    """Point counts [Q] for pre-packed queries (the serving hot path).
    ``q_terms`` (the cleaned terms) spares the compressed path an unpack."""
    if isinstance(idx, CompressedNGramIndex):
        return _c_lookup_packed(idx, q_lanes, q_len, valid, q_terms=q_terms)
    lead = packing.lead_term(q_lanes[:, 0], vocab_size=idx.vocab_size)
    lo, hi = _bracket(idx, idx.fanout, q_len, lead)
    pos = kops.bsearch(idx.lanes, q_lanes, lo, hi, upper=False,
                       steps=search_steps(idx.size))
    safe = pos.clamp(max=idx.size - 1).to(torch.int64)
    hit = (pos < hi) & (idx.lanes[safe] == q_lanes).all(dim=1) & valid
    return torch.where(hit, idx.counts[safe], 0)


def _lookup_single(idx, grams, lengths) -> torch.Tensor:
    grams, lengths, valid = _clean(idx, _on(idx, grams), _on(idx, lengths),
                                   lo_len=1)
    q_lanes = packing.pack_terms(grams, vocab_size=idx.vocab_size)
    return lookup_packed(idx, q_lanes, lengths, valid, q_terms=grams)


def continuations_packed(idx, p_lanes: torch.Tensor, p_len: torch.Tensor,
                         valid: torch.Tensor, *, k: int,
                         p_terms: torch.Tensor | None = None):
    """Top-k completions for pre-packed prefixes (see :func:`continuations`)."""
    if isinstance(idx, CompressedNGramIndex):
        return _c_continuations_packed(idx, p_lanes, p_len, valid, k=k,
                                       p_terms=p_terms)
    lead = packing.lead_term(p_lanes[:, 0], vocab_size=idx.vocab_size)
    lo, hi = _bracket(idx, idx.cont_fanout, p_len + 1, lead)
    steps = search_steps(idx.size)
    lb = kops.bsearch(idx.cont_prefix, p_lanes, lo, hi, upper=False, steps=steps)
    ub = kops.bsearch(idx.cont_prefix, p_lanes, lo, hi, upper=True, steps=steps)
    lb = torch.where(valid, lb, 0).to(torch.int64)
    ub = torch.where(valid, ub, 0).to(torch.int64)
    n_distinct = ub - lb
    total = idx.cont_cumsum[ub] - idx.cont_cumsum[lb]
    offs = lb[:, None] + torch.arange(k, device=lb.device)[None, :]
    in_group = offs < ub[:, None]
    safe = offs.clamp(max=idx.size - 1)
    terms = torch.where(in_group, idx.cont_last[safe], 0)
    counts = torch.where(in_group, idx.cont_counts[safe], 0)
    return n_distinct, total, terms, counts


def _continuations_single(idx, prefixes, p_len, *, k: int):
    prefixes, p_len, valid = _clean(idx, _on(idx, prefixes), _on(idx, p_len),
                                    lo_len=0)
    valid = valid & (p_len <= idx.sigma - 1)
    p_lanes = packing.pack_terms(prefixes, vocab_size=idx.vocab_size)
    return continuations_packed(idx, p_lanes, p_len, valid, k=k,
                                p_terms=prefixes)


# --------------------------------------------------------------------------- #
# generational dispatch
# --------------------------------------------------------------------------- #

def lookup_deferred(idx, grams, lengths) -> list:
    """Per-segment point counts, not yet summed (fold with :func:`collect_lookup`)."""
    if isinstance(idx, GenerationalIndex):
        return [_lookup_single(ix, grams, lengths) for ix in idx.segments]
    return [_lookup_single(idx, grams, lengths)]


def collect_lookup(parts: list, n: int) -> torch.Tensor:
    """Fold (at least one) per-segment lookups -> [n] int64, refusing loudly if a sum
    overflows uint32 (the query-time mirror of the merge fold's guard)."""
    acc = torch.zeros((n,), dtype=torch.int64, device=parts[0].device)
    for p in parts:
        acc += p
    if acc.numel() and int(acc.max()) > U32:
        raise ValueError(
            f"summed cf {int(acc.max())} across live segments overflows "
            "uint32; compact the index or raise tau")
    return acc


def lookup(idx, grams, lengths) -> torch.Tensor:
    """Collection frequencies [Q] of raw query grams [Q, sigma].

    Misses (gram absent / below tau / malformed) return 0.  ``idx`` may be a
    flat or compressed index or a :class:`GenerationalIndex`, whose answer is
    the sum of cf over live segments.
    """
    if not isinstance(idx, GenerationalIndex):
        return _lookup_single(idx, grams, lengths)
    segs = idx.segments
    if not segs:
        return torch.zeros((len(grams),), dtype=torch.int64, device=idx.device)
    if len(segs) == 1:
        return _lookup_single(segs[0], grams, lengths)
    return collect_lookup(lookup_deferred(idx, grams, lengths), len(grams))


def generational_continuation_sets(segments, fetch, *, k: int):
    """Certified-complete per-segment continuation answers + the fetch width.

    The cross-segment fold is only exact if every segment's *entire*
    continuation set of every queried prefix was fetched, so the width
    ladders over the whole batch: ask for top-m, check the returned (exact)
    n_distinct against m, and widen to the next power of two of the largest
    (at least doubling) on any miss.  The widest fetch holds [Q, m] int64
    terms and counts of every segment at once (the empty prefix sets m near
    the vocabulary size); ``chip_smoke.py`` prints its peak device memory.
    ``fetch(segment, m)`` returns the (nd, total, terms, counts) tuple.
    """
    m = max(int(k), 1)
    while True:
        per = [fetch(ix, m) for ix in segments]
        max_nd = max((int(p[0].max()) if p[0].numel() else 0 for p in per),
                     default=0)
        if max_nd <= m:
            return per, m
        m = max(m * 2, 1 << (max_nd - 1).bit_length())


def continuations(idx, prefixes, p_len, *, k: int):
    """Top-k next-token completions of each prefix [Q, sigma] (len 0..sigma-1).

    Returns (n_distinct [Q], total [Q], terms [Q, k], counts [Q, k]) int64:
    the number of distinct frequent continuations, their total mass, and the
    k highest-cf (next_term, cf) pairs, count-descending, zero-padded.

    For a :class:`GenerationalIndex` every segment's complete continuation
    set of each prefix is fetched (:func:`generational_continuation_sets`),
    and the sets fold exactly: per-term counts summed, ranked (cf desc, term
    asc).
    """
    if not isinstance(idx, GenerationalIndex):
        return _continuations_single(idx, prefixes, p_len, k=k)
    segs = idx.segments
    q = len(prefixes)
    if not segs:
        z = torch.zeros((q,), dtype=torch.int64, device=idx.device)
        zk = torch.zeros((q, k), dtype=torch.int64, device=idx.device)
        return z, z.clone(), zk, zk.clone()
    if len(segs) == 1:
        return _continuations_single(segs[0], prefixes, p_len, k=k)
    per, _ = generational_continuation_sets(
        segs, lambda ix, m: _continuations_single(ix, prefixes, p_len, k=m), k=k)
    return merge_continuation_results(per, k=k)
