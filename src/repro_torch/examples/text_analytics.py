"""The paper's use case (b): text analytics -- long maximal n-grams and their
time series (SSVI), i.e. "find recurring fragments of text and how they spread
over time" (port of ``examples/text_analytics.py``).

    PYTHONPATH=src python -m repro_torch.examples.text_analytics [--device cpu]
"""
import argparse

from repro_torch.core import NGramConfig, extensions_filter, suffix_sigma
from repro_torch.data import corpus as corpus_mod
from repro_torch.examples import parse_args


def main(argv=None) -> None:
    _, dev = parse_args(argparse.ArgumentParser(description=__doc__), argv)
    # CW-profile corpus with injected duplicated segments (quotations/boilerplate,
    # the long frequent n-grams of the paper's Fig. 2) + per-document years
    tokens, years = corpus_mod.zipf_corpus(
        150_000, corpus_mod.CW, seed=7, duplicate_frac=0.08, with_years=True,
        n_years=8)
    vocab = corpus_mod.CW.vocab_size

    # document splitting at infrequent terms (SSV) -- prunes most of the stream
    tau = 8
    split, removed = corpus_mod.split_at_infrequent(tokens, tau, vocab)
    print(f"document splitting removed {removed}/{tokens.size} occurrences")

    # analytics job: long n-grams, time-series aggregation per year bucket
    cfg = NGramConfig(sigma=30, tau=tau, vocab_size=vocab, n_buckets=8)
    stats = suffix_sigma.run(split, cfg, bucket_ids=years, device=dev)
    print(f"{len(stats)} n-grams with cf >= {tau} (sigma=30); "
          f"map records = {int(stats.counters['map_records'])}")

    # maximal filter: drop everything subsumed by a longer frequent fragment
    maximal = extensions_filter(stats, "max", device=dev)
    print(f"maximal n-grams: {len(maximal)}")

    series = maximal.to_series_dict()
    long_frags = sorted((g for g in series if len(g) >= 5),
                        key=lambda g: -int(series[g].sum()))[:5]
    print("\nlongest recurring fragments and their per-year series:")
    for g in long_frags:
        s = series[g]
        print(f"  len={len(g)} cf={int(s.sum())} series={s.tolist()} ids={g[:8]}…")
    if not long_frags:
        print("  (none above length 5 at this scale)")


if __name__ == "__main__":
    main()
