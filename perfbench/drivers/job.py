"""Driver ``job``: n-gram jobs back to back over one corpus.

Traffic parameters: ``method`` and ``combine_route`` of the job
(``NGramConfig``), ``warm_jobs`` run in set-up, ``trace_jobs`` run under
the profiler after the window of a ``--trace 1`` run.  The configuration
gives the corpus (``perfbench.corpus``), ``sigma`` and ``tau``.

Every job runs ``repro_torch.core.run_job`` on the same device-resident
corpus.  Each job's whole output (grams, lengths, counts) is checked.  The
first is checked against the plain reference, and each other job against
the first.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import corpus, devtrace
from perfbench.compare import compare_rows
from perfbench.reference.ngrams import job_counts

__all__ = ["run", "expected", "check", "same", "rows"]


def rows(grams, lengths, counts) -> SimpleNamespace:
    """A job output made of arrays, read as ``NGramStats`` is."""
    return SimpleNamespace(grams=grams, lengths=lengths, counts=counts)


def same(a, b) -> bool:
    """Two job outputs hold the same rows and counts in the same order."""
    return (a.grams.shape == b.grams.shape and np.array_equal(a.grams, b.grams)
            and np.array_equal(a.lengths, b.lengths) and np.array_equal(a.counts, b.counts))


def expected(tokens: torch.Tensor, config: dict, *, count_dtype=None):
    """The reference's output for the corpus: (grams, lengths, counts)."""
    return job_counts(tokens, int(config["sigma"]), int(config["tau"]),
                      count_dtype=count_dtype)


def check(bench, outs: list, want) -> None:
    """Fill the bench's checks from the jobs' outputs and the reference's."""
    first = outs[0]
    diff = compare_rows(want, (first.grams, first.lengths, first.counts))
    first_ok = not any(diff.values())
    differ = [i for i, o in enumerate(outs) if i and not same(o, first)]
    wrong = 0 if first_ok else len(outs) - len(differ)
    for i in differ:
        d = compare_rows(want, (outs[i].grams, outs[i].lengths, outs[i].counts))
        wrong += any(d.values())
    bench.attempted, bench.failed = len(outs), wrong
    bench.checks.add("grams_missing", diff["missing"], 0)
    bench.checks.add("grams_extra", diff["extra"], 0)
    bench.checks.add("counts_wrong", diff["counts"], 0)
    bench.checks.add("rows_out_of_order", diff["order"], 0)
    bench.checks.add("jobs_differ", len(differ), 0)


def run(bench) -> None:
    from repro_torch import core
    from repro_torch.obs import trace as obs_trace
    cfg_json, traffic, dev = bench.config, bench.traffic, bench.device
    tokens = corpus.make_corpus(cfg_json, bench.seed, dev)
    terms = int((tokens != 0).sum())
    bench.mark("corpus")
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.entries()
        bench.mark("kernels built or loaded")
    cfg = core.NGramConfig(sigma=int(cfg_json["sigma"]), tau=int(cfg_json["tau"]),
                           vocab_size=int(cfg_json["vocab_size"]), method=traffic["method"],
                           combine_route=traffic["combine_route"])

    def job():
        return core.run_job(tokens, cfg, device=dev)

    for i in range(int(traffic["warm_jobs"])):
        job()
        bench.mark(f"warm job {i + 1}")
    tracer = obs_trace.enable_tracing() if bench.trace else None
    outs, steps = [], []
    t0 = bench.window_opens()
    while True:
        s = time.perf_counter()
        outs.append(job())
        e = time.perf_counter()
        steps.append({"terms": terms, "s": e - s})
        if e - t0 >= bench.seconds:
            break
    bench.record["window_s"] = e - t0
    bench.window_closes()
    rec = bench.record
    rec.update(steps=steps, positions=int(tokens.shape[0]), sigma=cfg.sigma,
               vocab_size=cfg.vocab_size, counters=dict(outs[0].counters))
    if tracer is not None:
        rec["spans"] = list(tracer.events)
        n_traced = int(traffic["trace_jobs"])
        rec["traced"] = devtrace.traced(lambda: [outs.append(job()) for _ in range(n_traced)],
                                        tracer)
        rec["traced_jobs"] = n_traced
        obs_trace.disable_tracing()
        bench.mark("traced jobs")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(bench, outs, expected(tokens, cfg_json))
