"""The benchmark's query draw: grams taken at positions of the corpus, so a
gram is drawn as often as it occurs (weighted by its cf), with a share of
misses made of uniform random terms (the draw of the port's
``serve.service.make_query_stream``, rewritten to run on the device from
the benchmark's own generator)."""
from __future__ import annotations

import torch

__all__ = ["draw_grams"]


def draw_grams(tokens: torch.Tensor, n: int, *, width: int, min_len: int, max_len: int,
               miss_frac: float, vocab_size: int, gen: torch.Generator
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(grams [n, width] int32, lengths [n] int32) on the tokens' device.

    A hit starts at a uniformly drawn non-PAD position, has a length drawn
    from ``min_len..max_len`` and is cut before the first PAD after its
    start.  With probability ``miss_frac`` a row is instead ``min_len..
    max_len`` uniform random term ids.  Terms past a row's length are 0.
    """
    dev = tokens.device
    live = (tokens != 0).nonzero().squeeze(1)
    start = live[torch.randint(0, live.shape[0], (n,), device=dev, generator=gen)]
    want = torch.randint(min_len, max_len + 1, (n,), device=dev, generator=gen)
    padded = torch.cat([tokens, tokens.new_zeros(max_len)])
    window = padded[start[:, None] + torch.arange(max_len, device=dev)[None, :]].to(torch.int64)
    run = torch.cumprod((window != 0).to(torch.int64), dim=1).sum(dim=1)
    length = torch.minimum(want, run)

    miss = torch.rand(n, device=dev, generator=gen, dtype=torch.float64) < miss_frac
    miss_len = torch.randint(min_len, max_len + 1, (n,), device=dev, generator=gen)
    miss_terms = torch.randint(1, vocab_size + 1, (n, max_len), device=dev, generator=gen)
    window = torch.where(miss[:, None], miss_terms, window)
    length = torch.where(miss, miss_len, length)

    grams = torch.zeros((n, width), dtype=torch.int64, device=dev)
    keep = torch.arange(max_len, device=dev)[None, :] < length[:, None]
    grams[:, :max_len] = window * keep
    return grams.to(torch.int32), length.to(torch.int32)
