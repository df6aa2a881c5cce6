"""Corpora for the n-gram jobs (copy of ``repro.data.corpus``): synthetic
generators shaped like the paper's datasets, plus the SSV pre-processing
passes (document splitting at infrequent terms lives here).

Token-stream convention everywhere: 1-D int32, term ids 1..V, PAD(0) separates
documents/sentences (the paper uses sentence boundaries as n-gram barriers)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusProfile:
    """Scaled-down profiles of the paper's datasets (Table I)."""
    name: str
    vocab_size: int
    zipf_a: float
    mean_sentence_len: float
    std_sentence_len: float


# NYT: clean longitudinal news corpus; CW: noisy web corpus with heavier tail and
# more repeated boilerplate (modelled by a flatter Zipf + duplicated segments).
NYT = CorpusProfile("nyt", vocab_size=20_000, zipf_a=1.2, mean_sentence_len=18.96,
                    std_sentence_len=14.05)
CW = CorpusProfile("cw", vocab_size=60_000, zipf_a=1.05, mean_sentence_len=17.02,
                   std_sentence_len=17.56)
PROFILES = {"nyt": NYT, "cw": CW}


def zipf_corpus(n_tokens: int, profile: CorpusProfile = NYT, seed: int = 0,
                duplicate_frac: float = 0.0, with_years: bool = False,
                n_years: int = 21):
    """Zipf-distributed token stream with sentence separators.

    duplicate_frac > 0 re-injects copied segments (quotations / boilerplate -- the
    long frequent n-grams of Fig. 2).  with_years attaches a year bucket per token
    (document granularity) for the time-series extension.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, profile.vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-profile.zipf_a)
    probs /= probs.sum()
    toks = rng.choice(profile.vocab_size, size=n_tokens, p=probs).astype(np.int32) + 1

    # a small pool of "quotations" (idioms / boilerplate): repeated verbatim, they
    # create the long high-cf n-grams of the paper's Fig. 2
    pool = [rng.choice(profile.vocab_size,
                       size=rng.integers(8, 25), p=probs).astype(np.int32) + 1
            for _ in range(12)]

    # sentence separators at lognormal-ish intervals matching the profile moments
    out = []
    years = []
    i = 0
    year = 0
    while i < n_tokens:
        l = max(1, int(rng.normal(profile.mean_sentence_len, profile.std_sentence_len)))
        seg = toks[i:i + l]
        if duplicate_frac > 0 and rng.random() < duplicate_frac:
            seg = pool[rng.integers(0, len(pool))]
        out.append(seg)
        years.append(np.full(len(seg) + 1, year % n_years, np.int32))
        year += 1
        i += l
    stream = np.concatenate([np.concatenate([s, [0]]) for s in out]).astype(np.int32)
    if with_years:
        return stream, np.concatenate(years)[: stream.size]
    return stream


def unigram_counts(tokens, vocab_size: int) -> np.ndarray:
    return np.bincount(np.asarray(tokens), minlength=vocab_size + 1)


def split_at_infrequent(tokens, tau: int, vocab_size: int):
    """SSV 'Document Splits': replace terms with cf < tau by separators.

    Safe by the APRIORI principle -- no frequent n-gram contains an infrequent term.
    Returns (tokens', n_removed).  All methods benefit; large sigma especially."""
    toks = np.asarray(tokens)
    counts = unigram_counts(toks, vocab_size)
    infrequent = counts < tau
    infrequent[0] = False
    mask = infrequent[toks]
    out = np.where(mask, 0, toks).astype(np.int32)
    return out, int(mask.sum())


def scale_sample(tokens, frac: float, seed: int = 0) -> np.ndarray:
    """Random document subset at `frac` of the corpus (Fig. 6 scaling)."""
    docs = np.split(np.asarray(tokens), np.nonzero(np.asarray(tokens) == 0)[0] + 1)
    docs = [d for d in docs if d.size]
    rng = np.random.default_rng(seed)
    keep = rng.random(len(docs)) < frac
    kept = [d for d, k in zip(docs, keep) if k]
    if not kept:
        kept = docs[:1]
    return np.concatenate(kept).astype(np.int32)
