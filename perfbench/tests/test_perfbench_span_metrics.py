"""The stage and service readers (``combine_ms``, ``sort_ms``, ``reduce_ms``,
``canonical_stats_ms``, ``cache_ms.stream``, ``search_ms.stream``,
``cache_hit_share.stream``) on hand-made span lists and on the program's own
spans from a tiny traced run on the CPU."""
import numpy as np
import pytest
import torch

from perfbench import harness

JOB = ("combine_ms", "sort_ms", "reduce_ms", "canonical_stats_ms")
STREAM = ("cache_ms.stream", "search_ms.stream", "cache_hit_share.stream")


def read(name, spans):
    return harness.load_metric("layer_metrics", name).value({"spans": spans})


def ev(name, ts, dur, **args):
    return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "args": args}


def job(t0, combine, sort, reduce, canon):
    """One job's spans, microseconds from ``t0``: the stages inside
    ``round.stages`` and the host finish after it."""
    t, out = t0 + 10, []
    for name, dur in (("stage.combine", combine), ("stage.partition", 5),
                      ("stage.sort", sort), ("stage.reduce", reduce)):
        out.append(ev(name, t, dur, rows=100))
        t += dur
    out.append(ev("round.stages", t0 + 10, t - t0 - 10))
    out.append(ev("stages.canonical", t + 1, canon, rows=7))
    out.append(ev("plan.run", t0, t + canon + 2 - t0))
    return out


def test_job_readers_median_over_jobs():
    spans = (job(0, 1000, 3000, 2000, 500) + job(20_000, 2000, 5000, 4000, 900)
             + job(40_000, 4000, 4000, 3000, 700))
    assert read("combine_ms", spans) == 2.0
    assert read("sort_ms", spans) == 4.0
    assert read("reduce_ms", spans) == 3.0
    assert read("canonical_stats_ms", spans) == 0.7


def test_job_readers_count_only_spans_inside_plan_run():
    spans = job(0, 1000, 3000, 2000, 500) + [ev("stage.sort", 90_000, 50_000)]
    assert read("sort_ms", spans) == 3.0


@pytest.mark.parametrize("name", JOB + STREAM)
def test_readers_give_none_without_their_spans(name):
    """A program without the new spans (the parent's: ``plan.run`` and
    ``round.*`` only, or the stream's ``svc.ingest`` alone) reads None."""
    old = [ev("plan.run", 0, 100), ev("round.stages", 10, 50), ev("svc.ingest", 200, 30)]
    assert read(name, old) is None
    assert read(name, []) is None
    assert harness.load_metric("layer_metrics", name).value({}) is None


def delta(t0, cache, search, materialize_in, materialize_out, rows, hits):
    """One delta's spans: an ingest (with a rung built inside it), then a
    lookup with a consult, a search (with a rung built inside it) and puts."""
    c1, c2 = cache
    out = [ev("gen.materialize", t0 + 1, materialize_out),
           ev("svc.ingest", t0, materialize_out + 5, gen=t0)]
    t = t0 + materialize_out + 10
    out.append(ev("svc.cache", t, c1, rows=rows, hits=hits, gen=t0))
    out.append(ev("gen.materialize", t + c1 + 1, materialize_in))
    out.append(ev("svc.search", t + c1, search, gen=t0))
    out.append(ev("svc.cache", t + c1 + search, c2, puts=rows - hits, gen=t0))
    out.append(ev("svc.lookup", t, c1 + search + c2, gen=t0))
    return out


def test_stream_readers_group_by_delta():
    spans = (delta(0, (1000, 500), 4000, 1000, 9000, 100, 0)
             + delta(100_000, (2000, 1000), 7000, 0, 0, 100, 25)
             + delta(200_000, (3000, 2000), 6000, 2000, 3000, 200, 0))
    # cache per delta: 1.5, 3.0, 5.0 ms
    assert read("cache_ms.stream", spans) == 3.0
    # search less the rung built inside it: 3.0, 7.0, 4.0 ms (the rungs
    # built inside the ingests are not subtracted)
    assert read("search_ms.stream", spans) == 4.0
    assert read("cache_hit_share.stream", spans) == 100 * 25 / 400


def test_stream_spans_before_the_first_ingest_are_not_a_delta():
    spans = [ev("svc.cache", 0, 9000, rows=5, hits=5)] + delta(100, (1000, 1000), 3000, 0, 0, 10, 0)
    assert read("cache_ms.stream", spans) == 2.0
    assert read("cache_hit_share.stream", spans) == 100 * 5 / 15


def test_job_readers_on_the_programs_spans():
    from repro_torch.core import NGramConfig, run_job
    from repro_torch.obs import trace
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, 30, 4000), dtype=torch.int32)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=30)
    tracer = trace.enable_tracing()
    try:
        for _ in range(3):
            run_job(toks, cfg, device="cpu")
    finally:
        trace.disable_tracing()
    for name in JOB:
        v = read(name, tracer.events)
        assert v is not None and v > 0, name


def test_stream_readers_on_the_programs_spans():
    """Deltas, each followed by its lookups and continuations as the
    ``stream`` traffic sends them, and one lookup batch repeated: only the
    repeat, under the same generation, hits the cache."""
    from repro_torch.core import NGramConfig
    from repro_torch.obs import trace
    from repro_torch.serve.service import StreamingNGramService
    rng = np.random.default_rng(1)
    svc = StreamingNGramService(NGramConfig(sigma=3, tau=1, vocab_size=30),
                                compress=True, device="cpu")
    g = rng.integers(1, 31, (32, 3)).astype(np.int32)
    ln = rng.integers(1, 4, 32).astype(np.int32)
    tracer = trace.enable_tracing()
    try:
        for _ in range(4):
            svc.ingest(rng.integers(0, 30, 1500).astype(np.int32))
            svc.lookup(g, ln)
            svc.lookup(g, ln)      # the same batch, same generation: all hits
            svc.continuations(g, np.minimum(ln, 2), k=4)
    finally:
        trace.disable_tracing()
    assert read("cache_ms.stream", tracer.events) > 0
    assert read("search_ms.stream", tracer.events) > 0
    assert read("cache_hit_share.stream", tracer.events) == 100 * 32 / 96
