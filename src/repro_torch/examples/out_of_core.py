"""Out-of-core n-gram statistics: a corpus bigger than the device budget
(port of ``examples/out_of_core.py``).

    PYTHONPATH=src python -m repro_torch.examples.out_of_core [--device cpu]

The monolithic jobs materialize every map record on the device at once --
O(corpus x sigma) lanes -- so corpus size is capped by device memory.
The wave engine (``repro_torch.pipeline.WaveExecutor``) lifts the cap: the
corpus stays on the host and streams through the map/combine/sort/reduce
pipeline in fixed-size token waves (plus a sigma-1 halo, like the
distributed jobs' halo), folding per-wave partials through the segment-merge
path.  Here we *pretend* the device only fits ~16k tokens of job state and
run a corpus 6x that:

  * ``run()``    -- the whole job out of core, bit-identical to monolithic;
  * ``run_streaming()`` -- each wave lands as a fresh L0 of a
    ``GenerationalIndex`` (LSM compaction), so the corpus becomes *queryable
    while it is still being ingested* -- the end-to-end path
    ``serve_ngrams --streaming --wave-tokens`` drives.
"""
import argparse
import time

import numpy as np

from repro_torch.core import NGramConfig, run_job
from repro_torch.data import corpus as corpus_mod
from repro_torch.examples import parse_args
from repro_torch.index import lookup
from repro_torch.pipeline import WaveExecutor

DEVICE_BUDGET_TOKENS = 16_384          # pretend this is all the HBM we have
CORPUS_TOKENS = 6 * DEVICE_BUDGET_TOKENS


def main(argv=None) -> None:
    _, dev = parse_args(argparse.ArgumentParser(description=__doc__), argv)
    prof = corpus_mod.PROFILES["nyt"]
    tokens = corpus_mod.zipf_corpus(CORPUS_TOKENS, prof, seed=0,
                                    duplicate_frac=0.02)
    cfg = NGramConfig(sigma=3, tau=4, vocab_size=prof.vocab_size)
    ex = WaveExecutor(cfg, wave_tokens=DEVICE_BUDGET_TOKENS, device=dev)

    t0 = time.perf_counter()
    stats = ex.run(tokens)
    dt = time.perf_counter() - t0
    c = stats.counters
    print(f"out-of-core job: {len(tokens)} tokens in {int(c['waves'])} waves "
          f"of <= {DEVICE_BUDGET_TOKENS} -> {len(stats)} frequent grams "
          f"in {dt:.1f}s ({c['map_records']:.0f} map records)")

    # the wave fold is size-tiered (LSM rungs, like the serving index), so
    # merge work amortizes to O(total log waves) instead of re-merging the
    # whole running segment every wave
    print(f"segment fold work (tiered accumulator): "
          f"{int(c['fold_rows'])} rows through merge_segments")

    # exactness receipt: the monolithic job (which *can* still run at this
    # size) produces bit-identical output
    mono = run_job(tokens, cfg, device=dev)
    assert np.array_equal(stats.grams, mono.grams)
    assert np.array_equal(stats.counts, mono.counts)
    print("bit-identical to the monolithic job: OK")

    # streaming: every wave becomes a queryable generation immediately
    cfg1 = NGramConfig(sigma=3, tau=1, vocab_size=prof.vocab_size)
    t0 = time.perf_counter()
    gen, reports = WaveExecutor(cfg1, wave_tokens=DEVICE_BUDGET_TOKENS,
                                device=dev).run_streaming(tokens)
    dt = time.perf_counter() - t0
    merges = sum(r["merges"] for r in reports)
    print(f"streaming ingest: {len(reports)} waves -> {gen!r} "
          f"({merges} compaction merges, {dt:.1f}s)")
    top = stats.counts.argmax()
    g = stats.grams[top:top + 1]
    ln = stats.lengths[top:top + 1]
    cf = int(lookup(gen, g, ln)[0])
    print(f"hottest gram {tuple(int(x) for x in g[0, :ln[0]])}: cf={cf} "
          f"served from {gen.n_segments} live segments")
    assert cf == int(stats.counts[top])


if __name__ == "__main__":
    main()
