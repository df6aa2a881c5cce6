"""The port's observability (``repro_torch.obs``) against ``repro.obs`` on CPU.

Histograms must bucket and interpolate exactly as ``repro``'s do (and track
the numpy sample oracle to within one bucket); the null registry must do
nothing; the validators must reject what ``repro``'s reject; ``COUNTER_DOC``
must carry ``repro``'s keys.  The instruments the port publishes -- the
job counters a service ingest folds in, the generational index's ``gen.*``
gauges and counters, the compressed decode counters and the cache's mirror
-- must equal ``repro``'s after the same ingest, query and compaction
sequence, except the byte gauges of flat rungs, which count the port's
int64 lanes and are held to the port's own ``nbytes``.  A traced 8-wave run
must export a valid trace whose child spans cover the root, and
``repro``'s validators must accept the port's exports.  Exact throughout.
"""
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

from repro.core.stats import NGramConfig as JConfig
from repro.obs import metrics as jmetrics
from repro.obs import report as jreport
from repro.serve.service import StreamingNGramService as JService
from repro_torch.core import NGramConfig
from repro_torch.index import CompressedNGramIndex
from repro_torch.obs import metrics, report, trace
from repro_torch.pipeline import WaveExecutor
from repro_torch.serve import LRUQueryCache, StreamingNGramService
from test_compress import make_corpus

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends on both packages' disabled singletons."""
    for mod in (metrics, jmetrics):
        mod.set_registry(None)
    trace.disable_tracing()
    yield
    for mod in (metrics, jmetrics):
        mod.set_registry(None)
    trace.disable_tracing()


def samples(dist: str) -> np.ndarray:
    rng = np.random.default_rng({"uniform": 0, "lognormal": 1, "bimodal": 2}[dist])
    if dist == "uniform":
        return rng.uniform(0.0, 1.0, 5000)
    if dist == "lognormal":
        return rng.lognormal(-7.0, 1.0, 5000)       # latency-shaped, ~1 ms
    return np.concatenate([rng.uniform(1e-4, 2e-4, 2500),
                           rng.uniform(1e-2, 2e-2, 2500)])


# ------------------------------------------------------------ histograms

@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_histogram_quantiles_vs_numpy_oracle(dist):
    xs = samples(dist)
    h = metrics.Histogram("t")
    for x in xs:
        h.observe(x)
    b = np.asarray(h.boundaries)
    n = len(xs)
    for q in (0.5, 0.95, 0.99):
        est = h.quantile(q)
        # the order-statistic neighbourhood of q, widened by the estimate's
        # bucket width (the estimator stores buckets, not samples)
        ref_lo = float(np.quantile(xs, max(q - 1.5 / n, 0.0)))
        ref_hi = float(np.quantile(xs, min(q + 1.5 / n, 1.0)))
        i = int(np.searchsorted(b, est))
        lo = b[i - 1] if i > 0 else float(xs.min())
        hi = b[i] if i < len(b) else float(xs.max())
        w = hi - lo
        assert ref_lo - w - 1e-12 <= est <= ref_hi + w + 1e-12, (dist, q, est)
    assert h.count == n
    assert (h.min, h.max) == (xs.min(), xs.max())


@pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
def test_histogram_equals_repro(dist):
    """The same samples in both packages' histograms: identical snapshots
    (bucket counts, sum, extrema, every quantile)."""
    xs = samples(dist)
    hp, hj = metrics.Histogram("t"), jmetrics.Histogram("t")
    for x in xs:
        hp.observe(x)
        hj.observe(x)
    assert hp.snapshot() == hj.snapshot()
    qs = np.linspace(0.0, 1.0, 41)
    assert [hp.quantile(q) for q in qs] == [hj.quantile(q) for q in qs]
    assert metrics.default_latency_boundaries() == jmetrics.default_latency_boundaries()


def test_histogram_edges():
    h = metrics.Histogram("t", boundaries=[1.0, 2.0, 4.0])
    assert h.quantile(0.5) == 0.0                 # empty
    h.observe(3.0)
    assert h.quantile(0.0) <= 3.0 <= h.quantile(1.0) + 1e-12
    assert h.quantile(1.0) == 3.0                 # clamped to the observed max
    with pytest.raises(ValueError):
        h.quantile(1.5)
    for bad in ([2.0, 1.0], [1.0, 1.0], []):
        with pytest.raises(ValueError):
            metrics.Histogram("bad", boundaries=bad)
    h.observe(0.5)                                # below the first edge
    h.observe(9.0)                                # past the last edge
    assert h.counts == [1, 0, 1, 1]
    assert h.quantile(0.0) == 0.5 and h.quantile(1.0) == 9.0
    assert report.validate_metrics(
        {"counters": {}, "gauges": {}, "histograms": {"t": h.snapshot()}}) == []


def test_null_registry_instruments_are_noops():
    reg = metrics.get_registry()
    assert reg is metrics.null_registry and not reg
    reg.counter("c").add(5)
    reg.gauge("g").set(2)
    reg.histogram("h").observe(0.1)
    reg.merge_job_counters({"jobs": 1})
    assert metrics.get_registry().counter("c").value == 0
    assert reg.counter("a") is reg.gauge("b") is reg.histogram("c")   # one singleton


def test_merge_policy_sums_except_skew():
    dst = {"jobs": 2, "shuffle_skew": 1.5}
    metrics.merge_counter_dicts(dst, {"jobs": 3, "shuffle_skew": 1.2, "retries": 1})
    assert dst == {"jobs": 5, "shuffle_skew": 1.5, "retries": 1}
    snaps = []
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.merge_job_counters({"jobs": 2, "shuffle_skew": 3.5})
        reg.merge_job_counters({"jobs": np.int64(1), "shuffle_skew": 2.0})
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["counters"]["job.jobs"] == 3
    assert snaps[0]["gauges"]["job.shuffle_skew"] == 3.5


def test_counter_doc_keys_equal_repro():
    assert list(metrics.COUNTER_DOC) == list(jmetrics.COUNTER_DOC)
    assert metrics.MAX_MERGED_COUNTERS == jmetrics.MAX_MERGED_COUNTERS
    assert metrics.FLOAT_COUNTERS == jmetrics.FLOAT_COUNTERS


# ------------------------------------------------------------ validators

MALFORMED_TRACES = [
    {},
    {"traceEvents": "x"},
    {"traceEvents": []},
    {"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "dur": 1, "pid": 0, "tid": 0}]},
    {"traceEvents": [{"name": "", "ph": "X", "ts": -1, "dur": 1, "pid": 0.5, "tid": 0,
                      "args": []}]},
    {"traceEvents": [7]},
]

MALFORMED_METRICS = [
    [],
    {"counters": {}},
    {"counters": {"c": "nope"}, "gauges": {}, "histograms": {}},
    {"counters": {}, "gauges": {}, "histograms": {"h": 3}},
    {"counters": {}, "gauges": {}, "histograms": {
        "h": {"boundaries": [2.0, 1.0], "counts": [0, 0, 0], "count": 0, "sum": 0.0,
              "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}}},
    {"counters": {}, "gauges": {}, "histograms": {
        "h": {"boundaries": [1.0], "counts": [1, -1], "count": 0, "sum": 0.0,
              "min": 0.0, "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}}},
    {"counters": {}, "gauges": {}, "histograms": {
        "h": {"boundaries": [1.0], "counts": [1, 1], "count": 3, "sum": 0.0}}},
]


@pytest.mark.parametrize("i", range(len(MALFORMED_TRACES)))
def test_trace_validator_rejects_as_repro(i):
    obj = MALFORMED_TRACES[i]
    assert report.validate_trace(obj) != []
    assert report.validate_trace(obj) == jreport.validate_trace(obj)


@pytest.mark.parametrize("i", range(len(MALFORMED_METRICS)))
def test_metrics_validator_rejects_as_repro(i):
    obj = MALFORMED_METRICS[i]
    assert report.validate_metrics(obj) != []
    assert report.validate_metrics(obj) == jreport.validate_metrics(obj)


def test_report_cli_and_summary_table(tmp_path, capsys):
    """``setup`` wires a registry and a tracer, ``finish`` writes both files;
    the module's CLI validates them and refuses a broken file."""
    m, t = tmp_path / "m.jsonl", tmp_path / "t.json"
    finish = report.setup(str(t), str(m))
    metrics.get_registry().merge_job_counters({"jobs": 2, "shuffle_skew": 1.25})
    metrics.get_registry().histogram("lat").observe(0.002)
    with trace.span("outer"):
        with trace.span("inner"):
            pass
    reg = finish({"driver": "test"})
    metrics.set_registry(None)
    trace.disable_tracing()
    out = capsys.readouterr().out
    assert "job.jobs" in out and "lat" in out and f"metrics: {m}" in out
    (rec,) = report.read_jsonl(str(m))
    assert rec["driver"] == "test" and rec["metrics"] == reg.snapshot()
    env = rec["env"]
    assert env["torch_version"] == torch.__version__
    assert env["device_kind"] in ("cuda", "cpu") and env["device_count"] >= 0
    assert report.main(["--validate-metrics", str(m), "--validate-trace", str(t)]) == 0
    assert jreport.main(["--validate-metrics", str(m), "--validate-trace", str(t)]) == 0
    bad = tmp_path / "bad.jsonl"
    report.write_jsonl(str(bad), [{"metrics": MALFORMED_METRICS[2]}])
    assert report.main(["--validate-metrics", str(bad)]) == 1
    assert report.summary_table(rec["metrics"]) == jreport.summary_table(rec["metrics"])


# ------------------------------------------------------------ cache mirror

def test_lru_cache_publish_metrics_as_repro():
    from repro.serve.cache import LRUQueryCache as JCache
    snaps = []
    for cls, mod in ((LRUQueryCache, metrics), (JCache, jmetrics)):
        reg = mod.MetricsRegistry()
        c = cls(capacity=2)
        for i in range(4):
            c.get(("k", i), 0)
            c.put(("k", i), 0, i)
        assert c.get(("k", 3), 0) == 3
        c.publish_metrics(reg)
        c.publish_metrics(reg)                      # a lifetime mirror, not +=
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[0]["counters"] == {"cache.evictions": 2, "cache.hits": 1,
                                    "cache.misses": 4}
    metrics.set_registry(None)
    LRUQueryCache(capacity=2).publish_metrics()     # the null registry: no-op


# ------------------------------------------------------------ the registry vs repro

SIGMA, VOCAB = 3, 40


def byte_gauges(gen) -> dict:
    """Each live rung's byte gauge name -> whether it counts a compressed
    rung (equal to ``repro``'s) or a flat / bare one (the port's own bytes)."""
    return {f"gen.rung{i}_bytes_at_rest": isinstance(ix, CompressedNGramIndex)
            for i, ix in enumerate(gen.levels)}


def assert_registry_as_repro(port_reg, repro_reg, port_gen, compressed: dict):
    """Snapshots equal key for key; the byte gauges of rungs last published
    flat equal the port's bytes of that rung instead."""
    compressed.update(byte_gauges(port_gen))
    ps, js = port_reg.snapshot(), repro_reg.snapshot()
    assert ps["counters"] == js["counters"]
    assert ps["histograms"] == js["histograms"]
    assert ps["gauges"].keys() == js["gauges"].keys()
    for name, v in ps["gauges"].items():
        if compressed.get(name, True) and name != "gen.bytes_at_rest":
            assert v == js["gauges"][name], name
    if all(compressed.values()):
        assert ps["gauges"]["gen.bytes_at_rest"] == js["gauges"]["gen.bytes_at_rest"]
    for i, ix in enumerate(port_gen.levels):
        want = getattr(ix, "nbytes_at_rest", None) or ix.nbytes
        assert ps["gauges"][f"gen.rung{i}_bytes_at_rest"] == want
    assert ps["gauges"]["gen.bytes_at_rest"] == port_gen.nbytes_at_rest
    assert report.validate_metrics(ps) == [] and jreport.validate_metrics(ps) == []


def test_registry_snapshot_equals_repro_through_ingest_and_compaction():
    """Two services on the same batches (the port on its merge route,
    ``repro`` on its default k-way host route; both give the same rungs):
    after every ingest, query, materialization and the final
    ``compact_all``, the two registries agree on the job counters, every
    ``gen.*`` counter and row gauge, the decode counters and the cache's
    mirror; compressed rungs' byte gauges equal ``repro``'s."""
    toks = make_corpus(3000, VOCAB, "zipf", 5)
    parts = np.array_split(toks, 5)
    port = StreamingNGramService(NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB),
                                 compress=True, size_ratio=2, device="cpu")
    jsvc = JService(JConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), compress=True,
                    size_ratio=2)
    preg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    metrics.set_registry(preg)
    jmetrics.set_registry(jreg)
    rng = np.random.default_rng(0)
    compressed: dict = {}
    for part in parts:
        port.ingest(part)
        jsvc.ingest(part)
        assert_registry_as_repro(preg, jreg, port.gen, compressed)
        g = rng.integers(0, VOCAB + 1, (64, SIGMA)).astype(np.int32)
        ln = rng.integers(0, SIGMA + 1, 64).astype(np.int32)
        np.testing.assert_array_equal(port.lookup(g, ln), jsvc.lookup(g, ln))
        np.testing.assert_array_equal(port.continuations(g, np.minimum(ln, SIGMA - 1), k=4),
                                      jsvc.continuations(g, np.minimum(ln, SIGMA - 1), k=4))
        for svc in (port, jsvc):                  # queries materialized every rung
            svc.gen._publish_metrics()
            svc.cache.publish_metrics()
        assert_registry_as_repro(preg, jreg, port.gen, compressed)
    assert port.gen.compaction_stats["merges"] >= 2
    assert any(compressed.values()), "no compressed rung was ever published"
    port.gen.compact_all()
    jsvc.gen.compact_all()
    assert_registry_as_repro(preg, jreg, port.gen, compressed)
    snap = preg.snapshot()
    assert snap["counters"]["compress.rows_decoded"] > 0
    assert snap["counters"]["merge.blocks_decoded"] > 0
    assert snap["counters"]["gen.ingests"] == len(parts)
    assert snap["gauges"]["gen.segments"] == 1 == port.gen.n_segments
    assert snap["gauges"]["gen.rows"] == port.gen.n_rows == port.gen.levels[0].n_rows


def test_decode_counters_as_repro():
    """``decode_segment`` (through ``to_segment`` and a merge) counts the
    blocks and rows it decoded, as ``repro``'s does."""
    from repro.core import run_job as jrun
    from repro.index import build_compressed_index as jbuild
    from repro.index import merge_indexes as jmerge
    from repro_torch.core import run_job
    from repro_torch.index import build_compressed_index, merge_indexes
    snaps = []
    for mod, build, merge, job, cfg, kw in (
            (metrics, build_compressed_index, merge_indexes, run_job,
             NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), {"device": "cpu"}),
            (jmetrics, jbuild, jmerge, jrun, JConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), {})):
        reg = mod.MetricsRegistry()
        mod.set_registry(reg)
        ca, cb = (build(job(make_corpus(1500, VOCAB, "zipf", s), cfg, **kw),
                        vocab_size=VOCAB, **kw) for s in (6, 7))
        ca.to_segment()
        merge([ca, cb], route="kway")
        snaps.append(reg.snapshot())
        nb = -(-ca.n_rows // ca.block_size) * 2 + -(-cb.n_rows // cb.block_size)
        assert reg.counters == {"compress.rows_decoded": 2 * ca.n_rows + cb.n_rows,
                                "merge.blocks_decoded": nb}
    assert snaps[0] == snaps[1]


def test_pipelined_lookups_leave_inflight_gauge_at_zero():
    toks = make_corpus(1200, VOCAB, "zipf", 8)
    svc = StreamingNGramService(NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB),
                                device="cpu")
    svc.ingest(toks)
    reg = metrics.MetricsRegistry()
    metrics.set_registry(reg)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(1, VOCAB + 1, (16, SIGMA)).astype(np.int32),
                rng.integers(1, SIGMA + 1, 16).astype(np.int32)) for _ in range(5)]
    got = svc.lookup_pipelined(batches)
    assert [a.tolist() for a in got] == [svc.lookup(g, ln).tolist() for g, ln in batches]
    assert reg.snapshot()["gauges"] == {"serve.inflight": 0}


# ------------------------------------------------------------ traces

def test_traced_eight_wave_run_schema_and_coverage(tmp_path):
    """As ``tests/test_obs.py`` asserts of ``repro``: a traced 8-wave run
    exports a valid trace, one ``wave.submit`` a wave, and named child spans
    cover >= 90% of the root span's wall time; ``repro``'s validator and
    coverage agree."""
    toks = make_corpus(4000, 60, "zipf", 0)
    cfg = NGramConfig(sigma=3, tau=3, vocab_size=60)
    wave = -(-len(toks) // 8)
    tracer = trace.enable_tracing()
    try:
        stats = WaveExecutor(cfg, wave_tokens=wave, device="cpu").run(toks)
    finally:
        trace.disable_tracing()
    assert stats.counters["waves"] == 8
    path = tmp_path / "trace.json"
    tracer.save(str(path))
    obj = json.loads(path.read_text())
    assert report.validate_trace(obj) == [] and jreport.validate_trace(obj) == []
    names = {e["name"] for e in obj["traceEvents"]}
    assert {"wave.run", "wave.submit", "wave.collect", "wave.fold",
            "wave.finalize"} <= names
    assert sum(e["name"] == "wave.submit" for e in obj["traceEvents"]) == 8
    from repro.obs.trace import span_coverage as jcoverage
    cov = trace.span_coverage(obj, "wave.run")
    assert cov >= 0.90 and cov == jcoverage(obj, "wave.run")
    assert trace.span_coverage(obj, "wave.run", ("wave.submit",)) == \
        jcoverage(obj, "wave.run", ("wave.submit",))
    with pytest.raises(ValueError):
        trace.span_coverage(obj, "no.such.span")


def test_span_coverage_merges_overlaps():
    ev = lambda name, ts, dur: {"name": name, "ph": "X", "ts": ts, "dur": dur,
                                "pid": 0, "tid": 0}
    obj = {"traceEvents": [ev("root", 0, 100), ev("a", 10, 20), ev("b", 20, 20),
                           ev("c", 90, 50), ev("root", 5, 1)]}
    assert trace.span_coverage(obj, "root") == 0.4
    assert trace.span_coverage(obj, "root", ("a",)) == 0.2


# ------------------------------------------------- span ids, stage and service spans

STAGES = ("stage.combine", "stage.partition", "stage.sort", "stage.reduce")


def _traced(fn):
    tracer = trace.enable_tracing()
    try:
        out = fn()
    finally:
        trace.disable_tracing()
    return out, tracer.events


def _children(events, parent, name=None):
    return [e for e in events if e["args"]["parent"] == parent["args"]["id"]
            and (name is None or e["name"] == name)]


def test_disabled_span_is_the_shared_null_span():
    from repro_torch.pipeline.executor import _stage_span
    assert trace.get_tracer() is None
    assert trace.span("svc.lookup") is trace.NULL_SPAN
    assert _stage_span("stage.sort", torch.zeros((3, 2))) is trace.NULL_SPAN
    assert not trace.NULL_SPAN


def test_span_ids_unique_and_parents_per_thread():
    """Every event names its own id and the span open on its own thread when
    it opened: a span on another thread is a root there."""
    import threading

    def worker():
        with trace.span("t.other"):
            with trace.span("t.other_child"):
                pass

    def body():
        with trace.span("t.root"):
            with trace.span("t.child"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
                with trace.span("t.grandchild"):
                    pass
            with trace.span("t.sibling"):
                pass

    _, events = _traced(body)
    by = {e["name"]: e["args"] for e in events}
    assert len({a["id"] for a in by.values()}) == len(events) == 6
    assert by["t.root"]["parent"] is None and by["t.other"]["parent"] is None
    assert by["t.child"]["parent"] == by["t.sibling"]["parent"] == by["t.root"]["id"]
    assert by["t.grandchild"]["parent"] == by["t.child"]["id"]
    assert by["t.other_child"]["parent"] == by["t.other"]["id"]
    assert report.validate_trace({"traceEvents": events}) == []


@pytest.mark.parametrize("method,combine", [("suffix_sigma", "sort"),
                                            ("suffix_sigma", "hash"),
                                            ("apriori_scan", "sort")])
def test_job_stage_spans_nest_in_every_round(method, combine):
    """One of each stage span inside every ``round.stages``, with the rows
    it takes in, and one ``stages.canonical`` inside ``plan.run``."""
    from repro_torch.core import run_job
    toks = make_corpus(3000, VOCAB, "zipf", 4)
    cfg = NGramConfig(sigma=4, tau=2, vocab_size=VOCAB, method=method,
                      combine_route=combine)
    stats, events = _traced(lambda: run_job(toks, cfg, device="cpu"))
    plan = [e for e in events if e["name"] == "plan.run"]
    assert len(plan) == 1
    rounds = _children(events, plan[0], "round.stages")
    assert len(rounds) == sum(e["name"] == "round.stages" for e in events) >= 1
    if method == "apriori_scan":
        assert len(rounds) > 1
    for r in rounds:
        kids = _children(events, r)
        assert sorted(e["name"] for e in kids) == sorted(STAGES)
        rows = {e["name"]: e["args"]["rows"] for e in kids}
        assert rows["stage.partition"] == rows["stage.sort"] == rows["stage.reduce"] > 0
        assert rows["stage.combine"] >= rows["stage.sort"]
        for e in kids:
            assert r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]
    assert sum(e["name"] in STAGES for e in events) == 4 * len(rounds)
    canon = [e for e in events if e["name"] == "stages.canonical"]
    assert len(canon) == 1 and canon[0]["args"]["parent"] == plan[0]["args"]["id"]
    assert canon[0]["args"]["rows"] == len(stats)


def test_stage_spans_sync_on_the_job_path_only(monkeypatch):
    """The single job's stage spans ask for a device sync at their close;
    the wave engine's, inside ``wave.submit``, never do (a wave is enqueued
    whole).  Every tensor reads as a card's here, and the sync is counted."""
    from repro_torch.core import run_job
    flags, syncs = [], []
    finish = trace.Tracer._finish

    def spy(self, sp):
        flags.append((sp.name, sp._sync))
        finish(self, sp)

    monkeypatch.setattr(trace, "_on_cuda", lambda x: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1))
    monkeypatch.setattr(trace.Tracer, "_finish", spy)
    toks = make_corpus(2000, VOCAB, "zipf", 6)
    cfg = NGramConfig(sigma=3, tau=2, vocab_size=VOCAB)
    want, _ = _traced(lambda: run_job(toks, cfg, device="cpu"))
    job = [s for n, s in flags if n in STAGES]
    assert len(job) == 4 and all(job) and len(syncs) >= 4
    flags.clear()
    syncs.clear()
    got, _ = _traced(lambda: WaveExecutor(cfg, wave_tokens=500, device="cpu").run(toks))
    wave = [s for n, s in flags if n in STAGES]
    assert len(wave) == 4 * 4 and not any(wave)
    assert syncs == []
    assert np.array_equal(got.counts, want.counts)



def test_service_spans_count_rows_hits_and_generation():
    """``svc.lookup`` and ``svc.continuations`` hold a consulting
    ``svc.cache`` (rows, hits), a ``svc.search`` for the misses and a
    ``svc.cache`` of puts; the same batch twice under one generation hits on
    the second call, and a batch after an ingest hits nothing."""
    toks = make_corpus(2400, VOCAB, "zipf", 8)
    svc = StreamingNGramService(NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB),
                                device="cpu")
    _, ev_ingest = _traced(lambda: svc.ingest(toks[:1200]))
    ing = [e for e in ev_ingest if e["name"] == "svc.ingest"]
    assert len(ing) == 1 and ing[0]["args"]["gen"] == svc.gen.generation
    rng = np.random.default_rng(3)
    g = rng.integers(1, VOCAB + 1, (24, SIGMA)).astype(np.int32)
    ln = rng.integers(1, SIGMA + 1, 24).astype(np.int32)
    g[12:] = g[:12]
    ln[12:] = ln[:12]            # repeated within the batch: still misses

    def shape(events, root_name):
        root = [e for e in events if e["name"] == root_name]
        assert len(root) == 1
        kids = _children(events, root[0])
        assert all(e["args"]["gen"] == svc.gen.generation for e in [root[0], *kids])
        return [(e["name"], {k: v for k, v in e["args"].items()
                             if k in ("rows", "hits", "puts")}) for e in kids]

    first, ev1 = _traced(lambda: svc.lookup(g, ln))
    assert shape(ev1, "svc.lookup") == [
        ("svc.cache", {"rows": 24, "hits": 0}), ("svc.search", {}),
        ("svc.search", {}), ("svc.cache", {"puts": 24})]
    again, ev2 = _traced(lambda: svc.lookup(g, ln))
    assert shape(ev2, "svc.lookup") == [("svc.cache", {"rows": 24, "hits": 24})]
    assert np.array_equal(first, again)
    pg, pl = g, np.minimum(ln, SIGMA - 1)
    c1, ev3 = _traced(lambda: svc.continuations(pg, pl, k=3))
    assert shape(ev3, "svc.continuations") == [
        ("svc.cache", {"rows": 24, "hits": 0}), ("svc.search", {}),
        ("svc.cache", {"puts": 24})]
    c2, ev4 = _traced(lambda: svc.continuations(pg, pl, k=3))
    assert shape(ev4, "svc.continuations") == [("svc.cache", {"rows": 24, "hits": 24})]
    assert np.array_equal(c1, c2)
    svc.ingest(toks[1200:])
    _, ev5 = _traced(lambda: svc.lookup(g, ln))
    assert shape(ev5, "svc.lookup")[0] == ("svc.cache", {"rows": 24, "hits": 0})
    _, ev6 = _traced(lambda: svc.lookup_pipelined([(g, ln), (g[:5], ln[:5])]))
    cache = [e["args"] for e in ev6 if e["name"] == "svc.cache" and "rows" in e["args"]]
    assert [(a["rows"], a["hits"]) for a in cache] == [(24, 24), (5, 5)]
