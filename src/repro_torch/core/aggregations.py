"""Aggregations beyond occurrence counting, SSII / SSVI-B (port of
``repro.core.aggregations``).

Document frequency (df): the frequent-sequence-mining notion of support.
For the whole-gram emit that is a per-(gram, document) dedup before
counting, in one job (``document_frequencies``).  For SUFFIX-sigma the
prefix-level distinct-document count does not follow from one lexicographic
pass (distinct (prefix, doc) pairs are not contiguous below the full sort
key), so ``df_suffix_lengths`` runs one exact pass per length.

Inverted index: SUFFIX-sigma's sorted runs *are* posting lists -- each
frequent gram's run holds its (doc, multiplicity) evidence; ``postings``
extracts them from a doc-id-tagged job.

Every job runs on the card unless ``device`` says otherwise; the emits
build no window tensor: the whole grams of a position are its ``suffix_pack``
lanes AND ``pack.prefix_lane_masks``, as NAIVE's explode builds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import sort
from repro_torch.pipeline import stages
from .common import as_tokens, prefix_masks, suffix_lanes, term_present
from .stats import NGramConfig, NGramStats

__all__ = ["doc_ids_from_stream", "document_frequencies", "df_suffix_lengths",
           "postings"]


def doc_ids_from_stream(tokens) -> np.ndarray:
    """Dense document id per token position (empty documents -- consecutive
    separators -- don't consume ids, matching the oracle's doc enumeration)."""
    return _doc_ids(torch.as_tensor(np.asarray(tokens))).numpy().astype(np.int32)


def _doc_ids(tokens: torch.Tensor) -> torch.Tensor:
    """:func:`doc_ids_from_stream` on the tokens' device, int64 [N]: a
    position's raw id counts the separators before it, and the raw ids of
    real tokens (non-decreasing) are ranked densely."""
    raw = torch.cumsum(tokens == 0, dim=0) - (tokens == 0).to(torch.int64)
    live = torch.unique_consecutive(raw[tokens != 0])
    if live.numel() == 0:
        live = raw.new_zeros(1)
    return torch.searchsorted(live, raw)


def document_frequencies(tokens, cfg: NGramConfig, *, device=None) -> NGramStats:
    """df of every n-gram of length <= sigma: one job with a map-side
    (gram, doc) dedup.

    The map emits every (position, length) gram with its document as
    [N * sigma, n_lanes + 2] records = lanes | doc | weight; the sort on
    (lanes, doc) puts each (gram, doc) pair's occurrences together, and only
    the first of each keeps weight 1.  Those records are then in lane order
    already, so the whole-gram reducer (``stages.reduce_exact``, the count
    of ``common.count_exact_grams``) runs on them with no second sort; the
    doc lane's place holds the deduplicated weight.
    """
    tokens = as_tokens(tokens, device)
    dids = _doc_ids(tokens)
    sigma, vocab = cfg.sigma, cfg.vocab_size
    lanes = suffix_lanes(tokens, sigma, vocab)
    n, n_l = lanes.shape
    valid = term_present(lanes, sigma, vocab)                   # [N, sigma]
    rec = torch.empty((n, sigma, n_l + 2), dtype=torch.int64, device=lanes.device)
    grams = rec[:, :, :n_l]
    torch.bitwise_and(lanes[:, None, :], prefix_masks(sigma, vocab, lanes.device)[None, 1:],
                      out=grams)
    del lanes
    grams *= valid[:, :, None]
    rec[:, :, n_l] = dids[:, None]
    rec[:, :, n_l + 1] = valid
    rec = sort.sort_records(rec.view(n * sigma, n_l + 2), n_keys=n_l + 1)
    keys = rec[:, :n_l + 1]
    first = (keys != torch.roll(keys, 1, dims=0)).any(dim=1)
    first[:1] = True
    rec[:, n_l] = first & (rec[:, n_l + 1] > 0)      # one weight per (gram, doc)
    terms, flags, counts = stages.reduce_exact(rec, sigma=sigma, vocab_size=vocab)
    from repro_torch.pipeline.executor import materialize
    out = materialize((terms, flags, counts), cfg.tau)
    out.counters = {"map_records": int(valid.sum()), "jobs": 1}
    return out


def df_suffix_lengths(tokens, cfg: NGramConfig, *, device=None) -> NGramStats:
    """SUFFIX-sigma-flavoured df: one narrow pass per length (sigma jobs),
    each an exact distinct-document count for that length -- the honest
    multi-pass cost of df under suffix partitioning."""
    tokens = as_tokens(tokens, device)
    out: NGramStats | None = None
    for l in range(1, cfg.sigma + 1):
        st = document_frequencies(tokens, dataclasses.replace(cfg, sigma=l),
                                  device=tokens.device)
        keep = st.lengths == l
        part = NGramStats(
            np.pad(st.grams[keep], ((0, 0), (0, cfg.sigma - l))),
            st.lengths[keep], st.counts[keep],
            {"jobs": 1} if out is None else {})
        out = part if out is None else out.merged_with(part)
    out.counters["jobs"] = cfg.sigma
    return out


def postings(tokens, cfg: NGramConfig, *, device=None
             ) -> dict[tuple[int, ...], dict[int, int]]:
    """Inverted index from SUFFIX-sigma's sorted runs: doc -> count for each
    frequent gram (cf >= tau).

    The map emits [N, n_lanes + 2] records = lanes | weight | doc (the
    ``suffix_pack`` kernel writes the doc column, as it writes a series
    bucket).  For each length l, the live rows' (l-prefix lanes, doc) keys
    are sorted on the device, so each (gram, doc) pair is a run whose length
    is its multiplicity and each gram's pairs are contiguous; the grams
    whose multiplicities sum to tau or more are kept, and only their (gram,
    doc, count) triples go to the host, where the dict of dicts is built.
    """
    from .suffix_sigma import make_records
    tokens = as_tokens(tokens, device)
    dev = tokens.device
    sigma, vocab = cfg.sigma, cfg.vocab_size
    rec, _ = make_records(tokens, sigma=sigma, vocab_size=vocab,
                          bucket_ids=_doc_ids(tokens).to(torch.int32))
    n_l = rec.shape[1] - 2
    lanes, live, docs = rec[:, :n_l], rec[:, n_l] > 0, rec[:, n_l + 1]
    present = term_present(lanes, sigma, vocab)                 # [N, sigma]
    masks = prefix_masks(sigma, vocab, dev)
    out: dict[tuple[int, ...], dict[int, int]] = {}
    for l in range(1, sigma + 1):
        sel = live & present[:, l - 1]
        keys = sort.sort_records(
            torch.cat([lanes[sel] & masks[l], docs[sel, None]], dim=1), n_keys=n_l + 1)
        if keys.shape[0] == 0:
            continue
        new = torch.ones(keys.shape[0], dtype=torch.bool, device=dev)
        new[1:] = (keys[1:] != keys[:-1]).any(dim=1)
        starts = new.nonzero().squeeze(1)
        pairs = keys[starts]                                     # (gram, doc)
        mult = torch.diff(starts, append=starts.new_tensor([keys.shape[0]]))
        gram_new = torch.ones(pairs.shape[0], dtype=torch.bool, device=dev)
        gram_new[1:] = (pairs[1:, :n_l] != pairs[:-1, :n_l]).any(dim=1)
        gid = torch.cumsum(gram_new, dim=0) - 1
        cf = torch.zeros(int(gid[-1]) + 1, dtype=torch.int64,
                         device=dev).index_add_(0, gid, mult)
        hot = cf[gid] >= cfg.tau
        terms = packing.unpack_terms(pairs[hot, :n_l], vocab_size=vocab,
                                     sigma=sigma)[:, :l].cpu().numpy()
        for gram, doc, c in zip(map(tuple, terms.tolist()),
                                pairs[hot, n_l].cpu().tolist(), mult[hot].cpu().tolist()):
            out.setdefault(gram, {})[doc] = c
    return out
