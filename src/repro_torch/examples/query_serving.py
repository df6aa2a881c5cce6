"""Serve n-gram statistics: freeze a job's output, then query it like a
frontend (port of ``examples/query_serving.py``).

    PYTHONPATH=src python -m repro_torch.examples.query_serving [--device cpu]

Runs SUFFIX-sigma over a small corpus, freezes the result into the
device-resident index (``repro_torch.index``), and demonstrates the two
serving primitives: batched point-count lookup (with misses) and top-k
next-token completion -- the autocomplete / backoff-LM read path.  The size
printed is ``repro``'s layout's (``NGramIndex.nbytes_uint32``): the port
holds its lanes and counts as int64.
"""
import argparse

import numpy as np

from repro_torch.core import NGramConfig, run_job
from repro_torch.data.tokenizer import TermDictionary, sentences
from repro_torch.examples import parse_args
from repro_torch.index import build_index, continuations, lookup

TEXT = """
the quick brown fox jumps over the lazy dog. the quick brown fox runs over
the sleepy cat. the lazy dog sleeps all day. a quick brown bird watches the
lazy dog. the quick brown fox jumps over the fence. every lazy dog dreams of
the quick brown fox. the cat and the dog chase the quick brown fox.
"""


def main(argv=None) -> None:
    _, dev = parse_args(argparse.ArgumentParser(description=__doc__), argv)
    docs = sentences(TEXT)
    dictionary = TermDictionary.build(docs)
    tokens = dictionary.encode(docs)
    sigma = 4
    cfg = NGramConfig(sigma=sigma, tau=2, vocab_size=dictionary.vocab_size)
    stats = run_job(tokens, cfg, device=dev)
    idx = build_index(stats, vocab_size=dictionary.vocab_size, device=dev)
    print(f"froze {len(stats)} frequent n-grams into a "
          f"{idx.nbytes_uint32 / 1024:.1f} KiB index\n")

    def ids(words: str) -> tuple[int, ...]:
        # unknown words get an out-of-vocab id: the index answers cf=0 (a miss)
        return tuple(dictionary.term_to_id.get(w, dictionary.vocab_size + 1)
                     for w in words.split())

    queries = ["the quick brown fox", "lazy dog", "the fence",
               "purple fox", "dog"]
    grams = np.zeros((len(queries), sigma), np.int32)
    lengths = np.zeros(len(queries), np.int32)
    for i, qt in enumerate(queries):
        g = ids(qt)
        grams[i, :len(g)] = g
        lengths[i] = len(g)
    counts = lookup(idx, grams, lengths).cpu().numpy()
    print("point lookups (cf=0 -> miss / below tau):")
    for qt, cf in zip(queries, counts):
        print(f"  cf={int(cf)}  {qt!r}")

    prefixes = ["the quick brown", "the", "lazy"]
    k = 3
    pg = np.zeros((len(prefixes), sigma), np.int32)
    pl = np.zeros(len(prefixes), np.int32)
    for i, pt in enumerate(prefixes):
        g = ids(pt)
        pg[i, :len(g)] = g
        pl[i] = len(g)
    nd, total, terms, cnts = [x.cpu().numpy()
                              for x in continuations(idx, pg, pl, k=k)]
    print(f"\ntop-{k} completions (n_distinct, total mass, then term:cf):")
    for i, pt in enumerate(prefixes):
        comps = [f"{dictionary.decode_gram([t])[0]}:{int(c)}"
                 for t, c in zip(terms[i], cnts[i]) if c > 0]
        print(f"  {pt!r} -> n={int(nd[i])} total={int(total[i])}  "
              + " ".join(comps))


if __name__ == "__main__":
    main()
