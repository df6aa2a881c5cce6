"""Batched queries against a frozen :class:`~repro_torch.index.build.NGramIndex`
(port of the flat-index half of ``repro.index.query``).

Query plan, both views:

  1. length + lead-term bucket -> [lo, hi) bracket from the fanout table;
  2. lexicographic lower/upper bound on the packed lanes inside the bracket,
     through the ``bsearch`` kernel (its plain version on a CPU index);
  3. gather counts / top-k continuation rows at the found positions.

Misses and invalid queries resolve to count 0 / empty completion lists
through masks, never through control flow.  A query gram must have
1 <= len <= sigma, all terms in 1..vocab before the PAD tail, and nothing
after it; continuation prefixes allow len 0 (top-k unigrams).  The compressed
and generational layouts wait for later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from .build import NGramIndex, search_steps


def _on(idx: NGramIndex, x) -> torch.Tensor:
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


def _clean(idx: NGramIndex, grams: torch.Tensor, lengths: torch.Tensor,
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


def lookup_packed(idx: NGramIndex, q_lanes: torch.Tensor, q_len: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Point counts [Q] for pre-packed queries (the serving hot path)."""
    lead = packing.lead_term(q_lanes[:, 0], vocab_size=idx.vocab_size)
    lo, hi = _bracket(idx, idx.fanout, q_len, lead)
    pos = kops.bsearch(idx.lanes, q_lanes, lo, hi, upper=False,
                       steps=search_steps(idx.size))
    safe = pos.clamp(max=idx.size - 1).to(torch.int64)
    hit = (pos < hi) & (idx.lanes[safe] == q_lanes).all(dim=1) & valid
    return torch.where(hit, idx.counts[safe], 0)


def lookup(idx: NGramIndex, grams, lengths) -> torch.Tensor:
    """Collection frequencies [Q] of raw query grams [Q, sigma].

    Misses (gram absent / below tau / malformed) return 0 -- exactly the
    oracle's ``counts.get(gram, 0)`` for frequent-gram stores.
    """
    grams, lengths, valid = _clean(idx, _on(idx, grams), _on(idx, lengths),
                                   lo_len=1)
    q_lanes = packing.pack_terms(grams, vocab_size=idx.vocab_size)
    return lookup_packed(idx, q_lanes, lengths, valid)


def continuations_packed(idx: NGramIndex, p_lanes: torch.Tensor,
                         p_len: torch.Tensor, valid: torch.Tensor, *, k: int):
    """Top-k completions for pre-packed prefixes (see :func:`continuations`)."""
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


def continuations(idx: NGramIndex, prefixes, p_len, *, k: int):
    """Top-k next-token completions of each prefix [Q, sigma] (len 0..sigma-1).

    Returns (n_distinct [Q], total [Q], terms [Q, k], counts [Q, k]): the
    number of distinct frequent continuations, their total mass (sum of cf
    over all of them, not just the top k), and the k highest-cf
    (next_term, cf) pairs, count-descending, zero-padded.
    """
    prefixes, p_len, valid = _clean(idx, _on(idx, prefixes), _on(idx, p_len),
                                    lo_len=0)
    valid = valid & (p_len <= idx.sigma - 1)
    p_lanes = packing.pack_terms(prefixes, vocab_size=idx.vocab_size)
    return continuations_packed(idx, p_lanes, p_len, valid, k=k)
