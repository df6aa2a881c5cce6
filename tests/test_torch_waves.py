"""The port's wave engine against ``repro.pipeline.WaveExecutor`` on CPU.

``WaveExecutor.run`` must equal the monolithic job (``run_plan``) array for
array at every wave size, and ``repro``'s ``WaveExecutor.run`` on the
counters dict too (``jobs`` = rounds x waves, ``waves``, ``fold_rows``, the
worst wave's ``shuffle_skew``): for the four methods, the three
accumulators, the four merge routes and both combine routes, on single-token
waves, halos longer than the wave, partial last waves, a halo past the
corpus tail and the empty corpus.  Each wave's segment, collected on the
device from ``stages.segment_candidates``, must equal ``repro``'s host
collect and the stats route (``segment_from_wave_stats``).  ``run_streaming``
and the service's wave ingest must answer as ``repro``'s do, and
``lookup_pipelined`` as ``lookup``.  Every output is an integer: exact
throughout.  JAX's wave programs run for one wave size a method; the other
cases hold the port to its own ``run_plan``.
"""
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.pipeline as jpipeline
from repro.core.stats import NGramConfig as JConfig
from repro_torch.core import METHODS, NGramConfig, oracle, run_job
from repro_torch.obs import metrics, trace
from repro_torch.pipeline import DoubleBufferedDriver, WaveExecutor, plan_for, stages
import test_compress
from test_compress import make_corpus

# ``test_pipeline`` imports ``tests.test_compress``; where an installed package
# named ``tests`` shadows this folder, that name is bound to the module above
sys.modules.setdefault("tests.test_compress", test_compress)
from test_pipeline import doc_wave

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

ROUTES = ("kway", "merge", "device", "sort")


def assert_same_arrays(got, want):
    for f in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


def assert_same_stats(got, want):
    """Arrays, and the counters dict with its value types."""
    assert_same_arrays(got, want)
    assert got.counters == want.counters
    assert {k: type(v) for k, v in got.counters.items()} == \
        {k: type(v) for k, v in want.counters.items()}


def waves(toks, cfg, wave, **kw):
    return WaveExecutor(cfg, wave_tokens=wave, device="cpu", **kw).run(toks)


def check_wave_parity(toks, cfg, wave, **kw):
    """The port's wave run equals its monolithic job; returns it."""
    got = waves(toks, cfg, wave, **kw)
    assert_same_arrays(got, run_job(toks, cfg, device="cpu"))
    if wave is not None:
        assert got.counters["waves"] == max(1, -(-len(toks) // max(1, min(wave, len(toks)))))
    return got


def jconfig(cfg) -> JConfig:
    """``repro``'s config of the port's ``cfg`` (``use_kernels`` off)."""
    return JConfig(**{f: getattr(cfg, f) for f in (
        "sigma", "tau", "vocab_size", "method", "combine", "combine_route", "pack",
        "pack_vocab", "apriori_index_k", "n_buckets")})


def check_against_repro(toks, cfg, wave, **kw):
    """The port's wave run equals ``repro``'s wave run (arrays and counters)
    and the port's monolithic job (arrays)."""
    got = check_wave_parity(toks, cfg, wave, **kw)
    want = jpipeline.WaveExecutor(jconfig(cfg), wave_tokens=wave, **kw).run(toks)
    assert_same_stats(got, want)
    return got


# ------------------------------------------------------------ parity grid
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("wave", ["corpus", "doc", 17])
def test_wave_parity(method, wave):
    toks = make_corpus(400, 23, "zipf", seed=7)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=23, method=method,
                      apriori_index_k=2)
    w = {"corpus": len(toks) + 5, "doc": doc_wave(toks)}.get(wave, wave)
    if wave == 17:              # and repro's monolithic job
        got = check_against_repro(toks, cfg, w)
        assert_same_arrays(got, jpipeline.run_plan(toks, jconfig(cfg)))
    else:
        got = check_wave_parity(toks, cfg, w)
    assert got.counters["jobs"] == plan_for(cfg).rounds * got.counters["waves"]


@pytest.mark.parametrize("method", sorted(METHODS))
def test_wave_parity_single_token_waves(method):
    """wave = 1: every token is its own wave."""
    toks = make_corpus(60, 9, "uniform", seed=3)
    cfg = NGramConfig(sigma=3, tau=2, vocab_size=9, method=method,
                      apriori_index_k=1)
    got = check_wave_parity(toks, cfg, 1)
    assert got.to_dict() == oracle.ngram_counts(toks, 3, 2)


def test_wave_parity_sigma_exceeds_wave():
    """A halo longer than the wave (sigma - 1 > wave): suffixes span several
    wave boundaries."""
    toks = make_corpus(120, 7, "zipf", seed=11)
    check_against_repro(toks, NGramConfig(sigma=6, tau=1, vocab_size=7), 3)


@pytest.mark.parametrize("tail", [1, 2, 16])
def test_wave_parity_corpus_not_multiple_of_wave(tail):
    """The last, partial wave carries its true live count."""
    wave = 64
    toks = np.asarray(make_corpus(400, 19, "zipf", seed=21))[: 5 * wave + tail]
    assert len(toks) % wave == tail
    got = check_wave_parity(toks, NGramConfig(sigma=4, tau=2, vocab_size=19), wave)
    assert got.counters["waves"] == 6


def test_wave_halo_spans_corpus_tail():
    """The last wave's halo is all padding: no tail gram lost or made up."""
    wave = 7
    toks = np.asarray(make_corpus(200, 11, "zipf", seed=23))
    toks = toks[: (len(toks) // wave) * wave + 1]
    cfg = NGramConfig(sigma=5, tau=1, vocab_size=11)
    got = check_against_repro(toks, cfg, wave)
    assert got.to_dict() == oracle.ngram_counts(toks, 5, 1)


def test_wave_empty_corpus():
    """Zero tokens: one empty wave, an empty output with ``repro``'s
    counters, and an empty queryable streaming index."""
    from repro_torch.index import lookup
    empty = np.zeros((0,), np.int32)
    for method in ("suffix_sigma", "naive"):
        cfg = NGramConfig(sigma=3, tau=1, vocab_size=9, method=method)
        got = waves(empty, cfg, 8)
        assert len(got) == 0 and got.counters["waves"] == 1
        assert_same_stats(got, jpipeline.WaveExecutor(jconfig(cfg),
                                                      wave_tokens=8).run(empty))
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=9)
    gen, reports = WaveExecutor(cfg, wave_tokens=8, device="cpu").run_streaming(empty)
    assert len(reports) == 1 and gen.generation == 1 and gen.n_segments == 0
    g = np.asarray([[1, 2, 0]], np.int32)
    assert int(lookup(gen, g, np.asarray([2], np.int32))[0]) == 0


def test_suffix_map_record_invariant_across_waves():
    """One map record a token occurrence, wave-split or not (SSIV)."""
    toks = make_corpus(500, 20, "uniform", seed=8)
    n_tok = int((np.asarray(toks) != 0).sum())
    got = waves(toks, NGramConfig(sigma=4, tau=1, vocab_size=20, combine=False), 97)
    assert got.counters["map_records"] == got.counters["shuffle_records"] == n_tok


@pytest.mark.parametrize("route", ["sort", "hash"])
def test_combine_routes_match_repro(route):
    toks = make_corpus(600, 18, "zipf", seed=2)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=18, combine_route=route)
    got = check_against_repro(toks, cfg, 150)
    assert got.to_dict() == oracle.ngram_counts(toks, 4, 2)


def test_wave_parity_unpacked_lane_fallback():
    """``pack=False`` packs lanes with another vocabulary than the segment's:
    the direct collect turns itself off and the stats route folds."""
    toks = make_corpus(200, 11, "zipf", seed=13)
    cfg = NGramConfig(sigma=3, tau=2, vocab_size=11, pack=False)
    assert not WaveExecutor(cfg, wave_tokens=37, device="cpu")._direct
    check_against_repro(toks, cfg, 37)


# ------------------------------------------------------- accumulators, routes
@pytest.mark.parametrize("accumulator", ["defer", "tiered", "pairwise"])
def test_accumulators_match_repro(accumulator):
    """Each accumulator's output and ``fold_rows`` equal ``repro``'s."""
    toks = make_corpus(2500, 50, "zipf", seed=31)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=50)
    got = check_against_repro(toks, cfg, -(-len(toks) // 16),
                              accumulator=accumulator)
    assert got.counters["fold_rows"] > 0


@pytest.mark.parametrize("route", ROUTES)
def test_merge_routes_agree(route):
    """Every merge route, under the deferred and the tiered fold, gives the
    monolithic output and the same counters."""
    toks = make_corpus(2000, 40, "zipf", seed=41)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=40)
    wave = -(-len(toks) // 8)
    want = {acc: waves(toks, cfg, wave, accumulator=acc) for acc in ("defer", "tiered")}
    for acc, ref in want.items():
        got = check_wave_parity(toks, cfg, wave, accumulator=acc, merge_route=route)
        assert got.counters == ref.counters


def test_default_route_is_merge():
    """The port's default fold route is the card's ``merge``; ``repro``'s is
    the host ``kway``."""
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=9)
    assert WaveExecutor(cfg, device="cpu").merge_route == "merge"
    assert jpipeline.WaveExecutor(jconfig(cfg)).merge_route == "kway"


def test_segment_accumulators_match_repro():
    """Unit level: the same segments through each accumulator give the
    segment of one merge of everything, and ``repro``'s ``fold_rows``."""
    import repro.index.build as jbuild
    import repro.index.merge as jmerge
    from repro_torch.index import (DeferredSegmentAccumulator, PairwiseSegmentAccumulator,
                                   TieredSegmentAccumulator, merge_segments,
                                   segment_from_stats)
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=15)
    stats = [run_job(make_corpus(150 + 40 * s, 15, "zipf", seed=s), cfg, device="cpu")
             for s in range(6)]
    segs = [segment_from_stats(s, vocab_size=15, device="cpu") for s in stats]
    jsegs = [jbuild.segment_from_stats(s, vocab_size=15) for s in stats]
    want = merge_segments(segs, route="sort")
    for port, jacc in ((TieredSegmentAccumulator(route="sort", size_ratio=2),
                        jmerge.TieredSegmentAccumulator(route="kway", size_ratio=2)),
                       (PairwiseSegmentAccumulator(route="merge"),
                        jmerge.PairwiseSegmentAccumulator(route="kway")),
                       (DeferredSegmentAccumulator(),
                        jmerge.DeferredSegmentAccumulator())):
        for s, j in zip(segs, jsegs):
            port.push(s)
            jacc.push(j)
        got = port.result()
        jacc.result()
        r = want.n_rows
        assert got.n_rows == r
        assert torch.equal(got.keys[:r], want.keys[:r])
        assert torch.equal(got.counts[:r], want.counts[:r])
        assert port.fold_rows == jacc.fold_rows > 0
    with pytest.raises(ValueError):
        TieredSegmentAccumulator().result()


# --------------------------------------------------------------- the collect
@pytest.mark.parametrize("method", sorted(METHODS))
def test_device_collect_matches_numpy_collect_and_stats_route(method):
    """Per wave: the port's collect on the device (candidates, compaction,
    sort) == ``repro``'s host numpy collect == the port's stats route, and
    the wave counters equal ``repro``'s."""
    from repro_torch.index.build import segment_from_wave_stats
    toks = np.asarray(make_corpus(300, 23, "zipf", seed=9), np.int32)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=23, method=method,
                      apriori_index_k=2)
    ex = WaveExecutor(cfg, wave_tokens=61, device="cpu")
    jex = jpipeline.WaveExecutor(jconfig(cfg), wave_tokens=61)
    assert ex._direct and jex._direct
    for (_, tok_ext, n_live), (jtok, jn) in zip(ex._windows(toks), jex._windows(toks)):
        assert n_live == jn
        np.testing.assert_array_equal(tok_ext.numpy(), np.asarray(jtok))
        part = ex._collect_wave_segment(ex._submit_wave(tok_ext, n_live))
        jpart = jex._collect_wave_segment(jex._submit_wave(jtok, jn))
        stats_route = segment_from_wave_stats(
            ex._collect_wave(ex._submit_wave(tok_ext, n_live)), vocab_size=23,
            device="cpu")
        assert part.n_rows == jpart.n_rows == stats_route.n_rows
        want = np.asarray(jpart.segment.keys).astype(np.int64)
        np.testing.assert_array_equal(part.segment.keys.numpy(), want)
        np.testing.assert_array_equal(stats_route.keys.numpy(), want)
        want_c = np.asarray(jpart.segment.counts).astype(np.int64)
        np.testing.assert_array_equal(part.segment.counts.numpy(), want_c)
        np.testing.assert_array_equal(stats_route.counts.numpy(), want_c)
        assert part.counters == jpart.counters


@pytest.mark.parametrize("method", ["suffix_sigma", "apriori_scan"])
def test_collect_in_row_chunks_equals_whole(method, monkeypatch):
    """The collect builds candidates ``_COLLECT_ROWS`` reducer rows at a time:
    chunks of 7 rows (ragged at every round's end) give the whole wave's
    segment and ``repro``'s output."""
    from repro_torch.pipeline import executor
    toks = make_corpus(300, 23, "zipf", seed=12)
    cfg = NGramConfig(sigma=4, tau=1, vocab_size=23, method=method)
    whole = waves(toks, cfg, 61)
    monkeypatch.setattr(executor, "_COLLECT_ROWS", 7)
    assert_same_stats(check_against_repro(toks, cfg, 61), whole)


@pytest.mark.parametrize("reduce_kind", ["suffix", "exact"])
def test_segment_candidates_match_repro(reduce_kind):
    """``stages.segment_candidates`` on seeded dense reducer outputs, against
    ``repro``'s (dead rows zeroed in both)."""
    import jax.numpy as jnp
    import repro.pipeline.stages as jstages
    from repro_torch.mapreduce import pack
    rng = np.random.default_rng(5)
    sigma, vocab, n = 5, 20_000, 300
    n_l = pack.n_lanes(sigma, vocab)
    lanes = rng.integers(0, 2**32, (n, n_l)).astype(np.int64)
    if reduce_kind == "suffix":
        flags = rng.random((n, sigma)) < 0.4
    else:               # at most one flagged length a row
        flags = np.zeros((n, sigma), bool)
        flags[np.arange(n), rng.integers(0, sigma, n)] = rng.random(n) < 0.6
    counts = (rng.integers(0, 4, (n, sigma)) * flags).astype(np.int32)
    masks = pack.prefix_lane_masks(sigma, vocab)
    keys, cnts = stages.segment_candidates(
        torch.as_tensor(flags), torch.as_tensor(counts), torch.as_tensor(lanes),
        torch.as_tensor(masks.astype(np.int64)), sigma=sigma, reduce_kind=reduce_kind)
    jkeys, jcnts = jstages.segment_candidates(
        jnp.asarray(flags), jnp.asarray(counts), jnp.asarray(lanes.astype(np.uint32)),
        jnp.asarray(masks), sigma=sigma, reduce_kind=reduce_kind)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts).astype(np.int64))


def test_iter_wave_stats_match_repro():
    toks = make_corpus(300, 19, "zipf", seed=4)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=19, method="apriori_index",
                      apriori_index_k=2)
    got = list(WaveExecutor(cfg, wave_tokens=70, device="cpu").iter_wave_stats(toks))
    want = list(jpipeline.WaveExecutor(jconfig(cfg), wave_tokens=70).iter_wave_stats(toks))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_same_arrays(g, w)
        assert g.counters == w.counters


# ------------------------------------------------------- scheduling, spans
def test_overlap_off_matches_overlap_on():
    toks = make_corpus(300, 19, "zipf", seed=17)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=19)
    on = waves(toks, cfg, 41)
    off = waves(toks, cfg, 41, overlap=False)
    assert_same_stats(on, off)
    cfg1 = NGramConfig(sigma=4, tau=1, vocab_size=19)
    g_on, r_on = WaveExecutor(cfg1, wave_tokens=41, device="cpu").run_streaming(toks)
    g_off, r_off = WaveExecutor(cfg1, wave_tokens=41, overlap=False,
                                device="cpu").run_streaming(toks)
    assert r_on == r_off and g_on.generation == g_off.generation


def test_one_round_stages_span_a_wave():
    """A multi-round plan's chain is one dispatch a wave: one ``round.stages``
    span a wave, and one collect and one fold."""
    toks = make_corpus(400, 23, "zipf", seed=5)
    n_waves = 8
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=23, method="apriori_scan")
    assert plan_for(cfg).rounds > 1
    tracer = trace.enable_tracing()
    try:
        waves(toks, cfg, -(-len(toks) // n_waves))
    finally:
        trace.disable_tracing()
    names = [e["name"] for e in tracer.events]
    for name, n in (("round.stages", n_waves), ("wave.submit", n_waves),
                    ("wave.collect", n_waves), ("wave.fold", n_waves),
                    ("wave.window.h2d", n_waves), ("wave.window.pad", 1),
                    ("wave.run", 1), ("wave.finalize", 1)):
        assert names.count(name) == n, name
    stages_args = [e["args"] for e in tracer.events if e["name"] == "round.stages"]
    assert all(a["fused_rounds"] == 4 for a in stages_args)


def test_double_buffered_driver_keeps_order():
    drv = DoubleBufferedDriver(lambda x: torch.full((2,), x))
    assert drv.submit(1, tag="a") == (None, None)
    res, tag = drv.submit(2, tag="b")
    assert tag == "a" and res.tolist() == [1, 1]
    res, tag = drv.drain()
    assert tag == "b" and res.tolist() == [2, 2]
    assert drv.drain() == (None, None)


def test_merge_counter_dicts_matches_repro():
    from repro.obs import metrics as jmetrics
    a = {"jobs": 2.0, "shuffle_skew": 3.5}
    b = {"jobs": 1.0, "map_records": 7.0, "shuffle_skew": 1.25}
    assert metrics.MAX_MERGED_COUNTERS == jmetrics.MAX_MERGED_COUNTERS
    assert metrics.merge_counter_dicts(dict(a), b) == \
        jmetrics.merge_counter_dicts(dict(a), b)


# ------------------------------------------------------- streaming, serving
def test_run_streaming_matches_repro():
    """Waves -> generational index: the same ingest reports as ``repro``'s,
    and lookups and continuations equal a flat build of the monolithic
    tau = 1 job."""
    from repro.index import continuations as jcontinuations
    from repro.index import lookup as jlookup
    from repro_torch.index import build_index, continuations, lookup
    rng = np.random.default_rng(5)
    toks = make_corpus(3000, 40, "zipf", seed=5)
    cfg = NGramConfig(sigma=4, tau=1, vocab_size=40)
    gen, reports = WaveExecutor(cfg, wave_tokens=512, device="cpu").run_streaming(
        toks, compress=True)
    jgen, jreports = jpipeline.WaveExecutor(jconfig(cfg), wave_tokens=512).run_streaming(
        toks, compress=True)
    assert reports == jreports and gen.generation == len(reports) == 6
    stats = run_job(toks, cfg, device="cpu")
    flat = build_index(stats, vocab_size=40, device="cpu")
    q = 96
    grams = np.zeros((q, 4), np.int32)
    lengths = np.zeros((q,), np.int32)
    rows = rng.choice(len(stats), q - 16)
    grams[: q - 16] = stats.grams[rows]
    lengths[: q - 16] = stats.lengths[rows]
    grams[q - 16:] = rng.integers(1, 46, (16, 4))
    lengths[q - 16:] = rng.integers(1, 5, 16)
    got = lookup(gen, grams, lengths).numpy()
    np.testing.assert_array_equal(got, lookup(flat, grams, lengths).numpy())
    np.testing.assert_array_equal(got, np.asarray(jlookup(jgen, grams, lengths)))
    p_len = np.maximum(lengths - 1, 0)
    for g, w, j in zip(continuations(gen, grams, p_len, k=6),
                       continuations(flat, grams, p_len, k=6),
                       jcontinuations(jgen, grams, p_len, k=6)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j).astype(np.int64))
    gen.compact_all()
    (rung,) = gen.segments
    assert rung.n_rows == len(stats)


def test_service_wave_ingest_matches_repro():
    """The service with ``wave_tokens`` ingests through one reused executor
    and serves what ``repro``'s wave service and the monolithic service do."""
    from repro.serve.service import StreamingNGramService as JService
    from repro_torch.serve import StreamingNGramService
    toks = make_corpus(1200, 25, "zipf", seed=9)
    more = make_corpus(500, 25, "zipf", seed=10)
    cfg = NGramConfig(sigma=3, tau=2, vocab_size=25)
    mono = StreamingNGramService(cfg, cache_capacity=64, device="cpu")
    svc = StreamingNGramService(cfg, cache_capacity=64, wave_tokens=200, device="cpu")
    jsvc = JService(jconfig(cfg), cache_capacity=64, wave_tokens=200)
    for batch in (toks, more):
        rm, rs, rj = mono.ingest(batch), svc.ingest(batch), jsvc.ingest(batch)
        assert rm["ingested_rows"] == rs["ingested_rows"] == rj["ingested_rows"]
        assert rs["waves"] == rj["waves"] == -(-len(batch) // 200) and rm["waves"] == 1
        assert (rs["merges"], rs["segment_rows"]) == (rj["merges"], rj["segment_rows"])
    ex = svc._wave_ex
    svc.ingest(more)
    assert svc._wave_ex is ex
    jsvc.ingest(more)
    mono.ingest(more)
    stats = run_job(np.concatenate([toks, more, more]), cfg, device="cpu")
    g = np.asarray(stats.grams)[:64]
    ln = np.asarray(stats.lengths)[:64]
    got = svc.lookup(g, ln)
    np.testing.assert_array_equal(got, mono.lookup(g, ln))
    np.testing.assert_array_equal(got, jsvc.lookup(g, ln))


def test_lookup_pipelined_equals_lookup():
    """Eight batches double-buffered over three live rungs, with repeats
    across batches (cache hits and misses mixed), equal ``lookup`` batch by
    batch on a twin service."""
    from repro_torch.serve import StreamingNGramService, make_query_stream
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=30)
    # shrinking deltas at size ratio 1 never compact: three live rungs
    toks = [make_corpus(n, 30, "zipf", 40 + i) for i, n in enumerate((1500, 300, 60))]
    svc = StreamingNGramService(cfg, cache_capacity=256, size_ratio=1, device="cpu")
    ref = StreamingNGramService(cfg, cache_capacity=256, size_ratio=1, device="cpu")
    for t in toks:
        for s in (svc, ref):
            s.ingest(t)
    assert svc.gen.n_segments == 3
    stats = run_job(np.concatenate(toks), cfg, device="cpu")
    g, ln = make_query_stream(stats, n_queries=8 * 64, sigma=3, vocab_size=30,
                              miss_frac=0.3, seed=1)
    batches = [(g[i * 64:(i + 2) * 64], ln[i * 64:(i + 2) * 64]) for i in range(8)]
    got = svc.lookup_pipelined(batches)
    assert len(got) == 8
    for (bg, bl), a in zip(batches, got):
        np.testing.assert_array_equal(a, ref.lookup(bg, bl))
    assert svc.cache.hits > 0
    assert svc.lookup_pipelined([]) == []


# ------------------------------------------------------------------ refusals
def test_wave_errors():
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=9)
    with pytest.raises(ValueError, match="n_buckets"):
        WaveExecutor(NGramConfig(sigma=3, tau=1, vocab_size=9, n_buckets=4),
                     wave_tokens=8, device="cpu")
    with pytest.raises(ValueError, match="accumulator"):
        WaveExecutor(cfg, wave_tokens=8, accumulator="nope", device="cpu")
    with pytest.raises(ValueError, match="wave_tokens"):
        WaveExecutor(cfg, wave_tokens=0, device="cpu")

    class Mesh:
        size = 2
    # a mesh of ranks runs the mesh waves (tests/test_torch_mesh_waves.py)
    assert WaveExecutor(cfg, wave_tokens=8, mesh=Mesh(), device="cpu")._use_mesh
    Mesh.size = 1                     # a one-device mesh is one device
    assert not WaveExecutor(cfg, wave_tokens=8, mesh=Mesh(), device="cpu")._use_mesh
    assert WaveExecutor(cfg, wave_tokens=8, mesh=Mesh(), device="cpu").run(
        np.asarray([1, 2, 3], np.int32)).to_dict() == {(1,): 1, (2,): 1, (3,): 1,
                                                       (1, 2): 1, (2, 3): 1,
                                                       (1, 2, 3): 1}
    ex = WaveExecutor(cfg, wave_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        ex.run(np.asarray([1, 2, 10]))
    with pytest.raises(ValueError, match="token ids"):
        ex.run_streaming(np.asarray([1, -2, 3]))
