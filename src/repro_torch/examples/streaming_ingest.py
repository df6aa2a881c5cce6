"""Streaming ingest: keep a served n-gram index fresh without rebuilds (port
of ``examples/streaming_ingest.py``).

    PYTHONPATH=src python -m repro_torch.examples.streaming_ingest [--device cpu]

Documents arrive in three batches.  Each batch runs through the ordinary
SUFFIX-sigma job phases and lands as a fresh L0 segment of a
``GenerationalIndex`` (LSM-style: immutable sorted segments, size-tiered
merges); point lookups sum evidence across live segments, so counts update the
moment a batch is swapped in -- watch ``cf`` grow for "the quick brown fox"
below.  Queries go through the streaming service's LRU cache, which
invalidates itself on every swap.
"""
import argparse

import numpy as np

from repro_torch.core import NGramConfig
from repro_torch.data.tokenizer import TermDictionary, sentences
from repro_torch.examples import parse_args
from repro_torch.serve import StreamingNGramService

BATCHES = [
    """the quick brown fox jumps over the lazy dog. the quick brown fox runs
    over the sleepy cat. the lazy dog sleeps all day.""",
    """a quick brown bird watches the lazy dog. the quick brown fox jumps over
    the fence. every lazy dog dreams of the quick brown fox.""",
    """the cat and the dog chase the quick brown fox. the quick brown fox
    outruns every lazy dog. the sleepy cat ignores the quick brown fox.""",
]


def main(argv=None) -> None:
    _, dev = parse_args(argparse.ArgumentParser(description=__doc__), argv)
    # one dictionary over the whole stream (a production system would grow it;
    # ids just need to be stable across batches)
    all_docs = sentences(" ".join(BATCHES))
    dictionary = TermDictionary.build(all_docs)
    sigma = 4
    cfg = NGramConfig(sigma=sigma, tau=2, vocab_size=dictionary.vocab_size)
    svc = StreamingNGramService(cfg, cache_capacity=1024, device=dev)

    def ids(words: str) -> tuple[int, ...]:
        return tuple(dictionary.term_to_id.get(w, dictionary.vocab_size + 1)
                     for w in words.split())

    watch = ["the quick brown fox", "lazy dog", "sleepy cat", "purple fox"]
    grams = np.zeros((len(watch), sigma), np.int32)
    lengths = np.zeros(len(watch), np.int32)
    for i, w in enumerate(watch):
        g = ids(w)
        grams[i, :len(g)] = g
        lengths[i] = len(g)

    for step, text in enumerate(BATCHES):
        tokens = dictionary.encode(sentences(text))
        rep = svc.ingest(tokens)
        counts = svc.lookup(grams, lengths)
        seg = "+".join(str(r) for r in rep["segment_rows"])
        print(f"batch {step}: +{len(tokens)} tokens -> segments [{seg}] "
              f"(merges={rep['merges']})")
        for w, cf in zip(watch, counts):
            print(f"    cf={int(cf)}  {w!r}")

    # the cache serves repeats without touching the device
    svc.lookup(grams, lengths)
    print(f"cache: {len(svc.cache)} entries, hit rate "
          f"{svc.cache.hit_rate:.0%} (invalidated on every swap)")

    k = 3
    prefixes = ["the quick brown", "the"]
    pg = np.zeros((len(prefixes), sigma), np.int32)
    pl = np.zeros(len(prefixes), np.int32)
    for i, p in enumerate(prefixes):
        g = ids(p)
        pg[i, :len(g)] = g
        pl[i] = len(g)
    rows = svc.continuations(pg, pl, k=k)
    print(f"top-{k} completions over all generations:")
    for i, p in enumerate(prefixes):
        comps = [f"{dictionary.decode_gram([t])[0]}:{int(c)}"
                 for t, c in zip(rows[i, 2:2 + k], rows[i, 2 + k:]) if c > 0]
        print(f"  {p!r} -> n={int(rows[i, 0])} total={int(rows[i, 1])}  "
              + " ".join(comps))


if __name__ == "__main__":
    main()
