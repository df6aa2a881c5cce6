"""Quickstart: compute n-gram statistics with SUFFIX-sigma on real text
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.core import NGramConfig, extensions_filter, run_job
from repro_torch.data.tokenizer import TermDictionary, sentences
from repro_torch.examples import parse_args

TEXT = """
to be or not to be that is the question. whether tis nobler in the mind to
suffer the slings and arrows of outrageous fortune. or to take arms against a
sea of troubles and by opposing end them. to die to sleep no more. and by a
sleep to say we end the heartache and the thousand natural shocks that flesh
is heir to. tis a consummation devoutly to be wished. to die to sleep. to
sleep perchance to dream ay theres the rub. for in that sleep of death what
dreams may come when we have shuffled off this mortal coil must give us pause.
to be or not to be is the question asked by many. to be or not to be they say.
"""


def main(argv=None) -> None:
    _, dev = parse_args(argparse.ArgumentParser(description=__doc__), argv)
    docs = sentences(TEXT)
    dictionary = TermDictionary.build(docs)            # ids by descending cf (SSV)
    tokens = dictionary.encode(docs)
    print(f"{len(docs)} sentences, {dictionary.vocab_size} distinct terms, "
          f"{int((tokens != 0).sum())} token occurrences\n")

    cfg = NGramConfig(sigma=6, tau=2, vocab_size=dictionary.vocab_size)
    stats = run_job(tokens, cfg, device=dev)
    print(f"SUFFIX-sigma found {len(stats)} n-grams with cf >= {cfg.tau}, "
          f"len <= {cfg.sigma}")
    print(f"counters: {({k: int(v) for k, v in stats.counters.items()})}\n")

    print("top n-grams:")
    for gram, cf in sorted(stats.to_dict().items(),
                           key=lambda kv: (-kv[1], -len(kv[0])))[:10]:
        print(f"  cf={cf}  {' '.join(dictionary.decode_gram(gram))}")

    maximal = extensions_filter(stats, "max", device=dev)
    print(f"\nmaximal n-grams ({len(maximal)} of {len(stats)}):")
    for gram, cf in sorted(maximal.to_dict().items(), key=lambda kv: -kv[1])[:8]:
        print(f"  cf={cf}  {' '.join(dictionary.decode_gram(gram))}")


if __name__ == "__main__":
    main()
