"""The benchmark's corpus generator: the Zipf token stream with sentence
separators and copied segments of the port's ``data/corpus.zipf_corpus``,
rewritten to run on the device in a few large calls from one seed.

The stream has exactly ``terms`` positions, PAD (0) separators included, so
every seed gives the same number of positions; only the words and the
sentence lengths change with the seed.  Term ids are ``1..vocab_size``,
drawn by rank with probability proportional to ``rank ** -zipf_a``.
Sentence lengths are ``max(1, int(normal(mean, std)))``.  With probability
``duplicate_frac`` a sentence is replaced by one of ``quotes`` copied
segments (lengths drawn from ``quote_len``), the long frequent n-grams of
the paper's Fig. 2.  Each sentence is followed by one PAD; the last one is
cut at the end of the stream.
"""
from __future__ import annotations

import torch

__all__ = ["generator", "make_corpus", "zipf_cdf", "zipf_draw"]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any integer up to
    2**64 - 1; larger or negative seeds are folded into that range)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def zipf_cdf(vocab_size: int, zipf_a: float, device) -> torch.Tensor:
    """Cumulative probabilities [V] (float64) of term ranks 1..V."""
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks.pow(-zipf_a), 0)
    return cdf / cdf[-1]


def zipf_draw(n: int, cdf: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``n`` term ids (int64, 1..V) drawn from ``cdf``."""
    u = torch.rand(n, dtype=torch.float64, device=cdf.device, generator=gen)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.shape[0] - 1) + 1


def make_corpus(spec: dict, seed: int, device) -> torch.Tensor:
    """The int32 token stream [spec["terms"]] of a configuration, on ``device``."""
    n = int(spec["terms"])
    gen = generator(seed, device)
    cdf = zipf_cdf(int(spec["vocab_size"]), float(spec["zipf_a"]), device)
    words = zipf_draw(n, cdf, gen)

    lo, hi = spec["quote_len"]
    n_quotes = int(spec["quotes"])
    q_len = torch.randint(int(lo), int(hi) + 1, (n_quotes,), device=device, generator=gen)
    q_words = zipf_draw(n_quotes * int(hi), cdf, gen).view(n_quotes, int(hi))

    # more sentences than can fit: each takes at least two positions
    m = n // 2 + 1
    length = torch.normal(float(spec["mean_sentence_len"]), float(spec["std_sentence_len"]),
                          (m,), device=device, generator=gen, dtype=torch.float64)
    length = length.to(torch.int64).clamp_(min=1)
    dup = torch.rand(m, device=device, generator=gen, dtype=torch.float64) \
        < float(spec["duplicate_frac"])
    quote = torch.randint(0, n_quotes, (m,), device=device, generator=gen)
    length = torch.where(dup, q_len[quote], length)

    # sentence s covers [start[s], start[s] + length[s]) and a PAD after it
    start = torch.cumsum(length + 1, 0) - (length + 1)
    pos = torch.arange(n, device=device)
    sent = torch.searchsorted(start, pos, right=True) - 1
    offset = pos - start[sent]
    is_dup = dup[sent]
    copied = q_words[quote[sent], offset.clamp(max=int(hi) - 1)]
    tok = torch.where(is_dup, copied, words)
    tok = torch.where(offset < length[sent], tok, 0)
    return tok.to(torch.int32)
