"""Driver ``stream``: a closed loop of deltas and queries on a streaming
n-gram service.

Traffic parameters: ``delta_positions`` (the corpus is cut into equal
deltas of that many positions), ``lookups`` and ``prefixes`` (query rows
after each delta), ``k`` (continuations a prefix), ``miss_frac`` (rows made
of random terms), the service's ``compress``, ``block_size``,
``size_ratio``, ``route`` and the job's ``combine_route``, and
``trace_cycles`` (cycles run under the profiler after the window of a
``--trace 1`` run).

One cycle starts a fresh ``StreamingNGramService`` and ingests every delta
in turn.  After each delta it sends one lookup batch and then one
continuation batch, both drawn in set-up.  Every cycle does the same work.
Set-up runs one whole cycle.  The window runs whole cycles: it closes at
the end of the first cycle that ends ``--seconds`` or more after it opened,
so every window holds the same mix of cheap early deltas and late ones that
cascade compactions.  Each delta's latency runs from its ``ingest`` call to
the return of the lookup batch after it.

Checked: every answer of every delta against the plain reference, and the
index the service holds, read rung by rung, both after the set-up cycle
and after the window's last cycle.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import corpus, devtrace
from perfbench.compare import compare_rows, union_rows
from perfbench.queries import draw_grams
from perfbench.reference.ngrams import StreamReference

__all__ = ["run", "Workload"]


class Workload:
    """The inputs of a stream run, made from the seed on the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.sigma, self.tau = int(config["sigma"]), int(config["tau"])
        self.vocab = int(config["vocab_size"])
        self.k = int(traffic["k"])
        self.tokens = corpus.make_corpus(config, seed, device)
        n, self.delta_len = self.tokens.shape[0], int(traffic["delta_positions"])
        if n % self.delta_len:
            raise ValueError(f"{n} positions do not cut into deltas of {self.delta_len}")
        n_deltas = n // self.delta_len
        self.deltas = list(self.tokens.split(self.delta_len))
        self.delta_terms = [int(x) for x in (self.tokens.view(n_deltas, -1) != 0).sum(1).tolist()]
        gen = corpus.generator(int(seed) * 2 + 1, device)
        common = dict(width=self.sigma, miss_frac=float(traffic["miss_frac"]),
                      vocab_size=self.vocab, gen=gen)
        self.lookups = [draw_grams(self.tokens, int(traffic["lookups"]), min_len=1,
                                   max_len=self.sigma, **common) for _ in range(n_deltas)]
        self.prefixes = [draw_grams(self.tokens, int(traffic["prefixes"]), min_len=1,
                                    max_len=self.sigma - 1, **common) for _ in range(n_deltas)]
        self.lookups_host = [(g.cpu().numpy(), ln.cpu().numpy()) for g, ln in self.lookups]
        self.prefixes_host = [(g.cpu().numpy(), ln.cpu().numpy()) for g, ln in self.prefixes]

    def reference(self, *, count_dtype=None) -> StreamReference:
        return StreamReference(self.tokens, sigma=self.sigma, tau=self.tau,
                               n_deltas=len(self.deltas), delta_len=self.delta_len,
                               queries=self.lookups + self.prefixes, count_dtype=count_dtype)


def index_rows(svc, sigma: int):
    """Every row the service's index holds, read rung by rung through the
    program's own segment views, summed into canonical order."""
    from repro_torch.index.build import IndexSegment
    from repro_torch.index.merge import segment_to_stats
    parts = []
    for entry in svc.gen.levels:
        seg = entry if isinstance(entry, IndexSegment) else entry.to_segment()
        st = segment_to_stats(seg)
        parts.append((st.grams, st.lengths, st.counts))
    return union_rows(parts, sigma)


def check(bench, work: Workload, answers: list, indexes: list, ref: StreamReference) -> None:
    """Fill the bench's checks: ``answers`` holds (delta, lookup answers,
    continuation rows) a step; ``indexes`` holds (delta, rows) of the index
    read after that delta."""
    n_deltas = len(work.deltas)
    want_l, want_c = {}, {}
    lk_wrong = ct_wrong = failed = 0
    for d, got_l, got_c in answers:
        if d not in want_l:
            want_l[d] = ref.lookups(d, d)
            want_c[d] = ref.continuations(n_deltas + d, d, work.k)
        wl = int(np.count_nonzero(np.asarray(got_l, np.int64) != want_l[d]))
        got_c = np.asarray(got_c, np.int64)
        wc = (int(np.count_nonzero((got_c != want_c[d]).any(axis=1)))
              if got_c.shape == want_c[d].shape else len(want_c[d]))
        lk_wrong += wl
        ct_wrong += wc
        failed += bool(wl or wc)
    idx_missing = idx_extra = idx_counts = idx_order = 0
    for d, rows in indexes:
        diff = compare_rows(ref.index(d), rows)
        idx_missing += diff["missing"]
        idx_extra += diff["extra"]
        idx_counts += diff["counts"]
        idx_order += diff["order"]
    bench.attempted, bench.failed = len(answers), failed
    bench.checks.add("lookups_wrong", lk_wrong, 0)
    bench.checks.add("continuations_wrong", ct_wrong, 0)
    bench.checks.add("index_rows_missing", idx_missing, 0)
    bench.checks.add("index_rows_extra", idx_extra, 0)
    bench.checks.add("index_counts_wrong", idx_counts, 0)
    bench.checks.add("index_out_of_order", idx_order, 0)


def run(bench) -> None:
    from repro_torch import core
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.service import StreamingNGramService
    t, dev = bench.traffic, bench.device
    work = Workload(bench.config, t, bench.seed, dev)
    bench.mark("corpus and queries")
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.entries()
        bench.mark("kernels built or loaded")
    cfg = core.NGramConfig(sigma=work.sigma, tau=work.tau, vocab_size=work.vocab,
                           combine_route=t["combine_route"])

    def service():
        return StreamingNGramService(cfg, compress=bool(t["compress"]),
                                     block_size=int(t["block_size"]),
                                     size_ratio=int(t["size_ratio"]), route=t["route"],
                                     device=dev)

    def step(svc, d: int, answers: list, steps: list) -> None:
        g, ln = work.lookups_host[d]
        pg, pl = work.prefixes_host[d]
        t_a = time.perf_counter()
        rep = svc.ingest(work.deltas[d])
        t_i = time.perf_counter()
        got_l = svc.lookup(g, ln)
        t_b = time.perf_counter()
        got_c = svc.continuations(pg, pl, k=work.k)
        t_c = time.perf_counter()
        answers.append((d, got_l, got_c))
        steps.append({"terms": work.delta_terms[d], "latency_s": t_b - t_a,
                      "job_s": rep["job_s"], "ingest_s": rep["ingest_s"],
                      "query_s": t_c - t_i})

    n_deltas = len(work.deltas)
    answers, warm_steps = [], []
    svc = service()
    for d in range(n_deltas):
        step(svc, d, answers, warm_steps)
    bench.mark("warm cycle")
    indexes = [(n_deltas - 1, index_rows(svc, work.sigma))]
    del svc
    gc.collect()
    bench.mark("index read")

    tracer = obs_trace.enable_tracing() if bench.trace else None
    steps = []
    t0 = bench.window_opens()
    while True:
        svc = None
        svc = service()
        for d in range(n_deltas):
            step(svc, d, answers, steps)
        if time.perf_counter() - t0 >= bench.seconds:
            break
    bench.record["window_s"] = time.perf_counter() - t0
    bench.window_closes()
    indexes.append((n_deltas - 1, index_rows(svc, work.sigma)))
    del svc
    bench.record["steps"] = steps
    if tracer is not None:
        bench.record["spans"] = list(tracer.events)

        def cycles():
            for _ in range(int(t["trace_cycles"])):
                s = service()
                for dd in range(n_deltas):
                    step(s, dd, answers, [])

        bench.record["traced"] = devtrace.traced(cycles, tracer)
        obs_trace.disable_tracing()
        bench.mark("traced cycle")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    check(bench, work, answers, indexes, work.reference())
