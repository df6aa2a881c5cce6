"""Pure-Python reference implementation -- the test oracle (copy of
``repro.core.oracle``).

Directly implements the problem statement of SSIII: every n-gram s with
cf(s) >= tau and |s| <= sigma, where cf is the number of (possibly overlapping)
occurrences across all documents.  Token streams use PAD(0) as the document /
sentence separator, matching the array encoding used by the jobs.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


def documents_from_stream(tokens) -> list[list[int]]:
    docs: list[list[int]] = []
    cur: list[int] = []
    for t in np.asarray(tokens).tolist():
        if t == 0:
            if cur:
                docs.append(cur)
            cur = []
        else:
            cur.append(int(t))
    if cur:
        docs.append(cur)
    return docs


def ngram_counts(tokens, sigma: int, tau: int) -> dict[tuple[int, ...], int]:
    cnt: Counter = Counter()
    for doc in documents_from_stream(tokens):
        n = len(doc)
        for b in range(n):
            for e in range(b, min(b + sigma, n)):
                cnt[tuple(doc[b:e + 1])] += 1
    return {g: c for g, c in cnt.items() if c >= tau}


def ngram_series(tokens, bucket_ids, sigma: int, tau: int,
                 n_buckets: int) -> dict[tuple[int, ...], np.ndarray]:
    """Time-series extension oracle (SSVI-B): per-bucket occurrence counts."""
    toks = np.asarray(tokens).tolist()
    buckets = np.asarray(bucket_ids).tolist()
    series: dict[tuple[int, ...], np.ndarray] = defaultdict(
        lambda: np.zeros(n_buckets, dtype=np.int64))
    start = 0
    for i in range(len(toks) + 1):
        if i == len(toks) or toks[i] == 0:
            doc = toks[start:i]
            bks = buckets[start:i]
            for b in range(len(doc)):
                for e in range(b, min(b + sigma, len(doc))):
                    series[tuple(doc[b:e + 1])][bks[b]] += 1
            start = i + 1
    return {g: s for g, s in series.items() if int(s.sum()) >= tau}


def ngram_document_frequencies(tokens, sigma: int, tau: int
                               ) -> dict[tuple[int, ...], int]:
    """df(s) = number of documents containing s (the frequent-sequence-mining
    'support' of SSII); filtered by df >= tau."""
    df: Counter = Counter()
    for doc in documents_from_stream(tokens):
        seen = set()
        n = len(doc)
        for b in range(n):
            for e in range(b, min(b + sigma, n)):
                seen.add(tuple(doc[b:e + 1]))
        for g in seen:
            df[g] += 1
    return {g: c for g, c in df.items() if c >= tau}


def ngram_postings(tokens, sigma: int, tau: int
                   ) -> dict[tuple[int, ...], dict[int, int]]:
    """Inverted index (SSVI-B): for each frequent n-gram, doc id -> in-doc count."""
    cnt = ngram_counts(tokens, sigma, tau)
    post: dict[tuple[int, ...], dict[int, int]] = {g: {} for g in cnt}
    for did, doc in enumerate(documents_from_stream(tokens)):
        n = len(doc)
        for b in range(n):
            for e in range(b, min(b + sigma, n)):
                g = tuple(doc[b:e + 1])
                if g in post:
                    post[g][did] = post[g].get(did, 0) + 1
    return post


def maximal_ngrams(stats: dict[tuple[int, ...], int]) -> dict[tuple[int, ...], int]:
    """r maximal iff no frequent s with r a *contiguous subsequence* of s (SSVI-A)."""
    grams = list(stats)
    frequent = set(grams)

    def has_frequent_super(r):
        lr = len(r)
        for s in frequent:
            if len(s) <= lr or s == r:
                continue
            for j in range(len(s) - lr + 1):
                if s[j:j + lr] == r:
                    return True
        return False

    return {g: c for g, c in stats.items() if not has_frequent_super(g)}


def closed_ngrams(stats: dict[tuple[int, ...], int]) -> dict[tuple[int, ...], int]:
    """r closed iff no frequent s (contiguous supersequence) with cf(s) == cf(r)."""
    def has_equal_super(r, c):
        lr = len(r)
        for s, cs in stats.items():
            if len(s) <= lr or cs != c:
                continue
            for j in range(len(s) - lr + 1):
                if s[j:j + lr] == r:
                    return True
        return False

    return {g: c for g, c in stats.items() if not has_equal_super(g, c)}


def expected_map_records(tokens, sigma: int, method: str) -> int:
    """Closed-form record counts from the paper's per-method analyses."""
    docs = documents_from_stream(tokens)
    if method == "suffix_sigma":
        return sum(len(d) for d in docs)                      # one per token (SSIV)
    if method == "naive":
        return sum(
            sum(min(sigma, len(d) - b) for b in range(len(d))) for d in docs
        )                                                     # every n-gram occurrence
    raise ValueError(method)
