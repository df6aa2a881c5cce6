"""The port's query service against ``repro.serve`` on CPU.

``LRUQueryCache`` must evict, invalidate and refuse stale writers as
``repro``'s does; ``StreamingNGramService`` with the hash combiner,
compressed rungs and merge-path compaction, fed the same batches as
``repro``'s service, must make the same merges and answer every lookup and
continuation the same, serve a repeated batch from the cache, and drop its
cache on ingest.  Exact throughout.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

from repro.core import run_job as jrun
from repro.core.stats import NGramConfig as JConfig
from repro.index import stats_union as jstats_union
from repro.serve.cache import LRUQueryCache as JCache
from repro.serve.service import StreamingNGramService as JService
from repro.serve.service import make_query_stream as jmake_query_stream
from repro_torch.core import NGramConfig, run_job
from repro_torch.serve import LRUQueryCache, StreamingNGramService, make_query_stream
from test_compress import make_corpus

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)


@pytest.mark.parametrize("cls", [LRUQueryCache, JCache], ids=["port", "repro"])
def test_lru_cache_eviction_and_invalidation(cls):
    c = cls(capacity=2)
    c.put("a", 1, 10)
    c.put("b", 1, 20)
    assert c.get("a", 1) == 10             # refreshes "a"
    c.put("x", 1, 30)                      # evicts LRU "b"
    assert c.get("b", 1) is None
    assert c.get("a", 1) == 10 and c.get("x", 1) == 30
    assert c.get("a", 2) is None           # generation swap drops everything
    assert len(c) == 0
    c.put("a", 2, 11)
    assert c.get("a", 2) == 11
    assert 0.0 < c.hit_rate < 1.0
    c.put("old", 1, 99)                    # a stale writer installs nothing
    assert c.generation == 2 and c.get("a", 2) == 11
    assert c.get("old", 2) is None
    assert c.get("a", 1) is None           # stale reader: miss, no clear
    assert c.get("a", 2) == 11
    assert c.snapshot() == {"hits": 6, "misses": 4, "evictions": 1, "entries": 1,
                            "generation": 2, "hit_rate": 0.6}
    with pytest.raises(ValueError):
        cls(capacity=0)


def test_make_query_stream_matches_repro():
    toks = make_corpus(2000, 30, "zipf", 3)
    stats = run_job(toks, NGramConfig(sigma=3, tau=2, vocab_size=30), device="cpu")
    for a, b in zip(make_query_stream(stats, n_queries=500, sigma=3, vocab_size=30,
                                      miss_frac=0.3, seed=4),
                    jmake_query_stream(stats, n_queries=500, sigma=3, vocab_size=30,
                                       miss_frac=0.3, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_streaming_service_matches_repro():
    vocab, sigma = 30, 3
    kw = dict(sigma=sigma, tau=1, vocab_size=vocab, combine_route="hash")
    svc = StreamingNGramService(NGramConfig(**kw), compress=True, route="merge",
                                cache_capacity=4096, device="cpu")
    jsvc = JService(JConfig(**kw), compress=True, route="merge", cache_capacity=4096)
    slices = [make_corpus(700, vocab, "zipf", 30 + i) for i in range(3)]
    for toks in slices:
        rep, jrep = svc.ingest(toks), jsvc.ingest(toks)
        assert (rep["ingested_rows"], rep["merges"], rep["segment_rows"]) == \
            (jrep["ingested_rows"], jrep["merges"], jrep["segment_rows"])
    assert [type(ix).__name__ for ix in svc.gen.segments] == \
        [type(ix).__name__ for ix in jsvc.gen.segments]
    exp = jstats_union(*[jrun(t, JConfig(**kw)) for t in slices]).to_dict()
    tuples = sorted(exp)
    g = np.zeros((len(tuples), sigma), np.int32)
    ln = np.zeros(len(tuples), np.int32)
    for i, t in enumerate(tuples):
        g[i, :len(t)] = t
        ln[i] = len(t)
    got = svc.lookup(g, ln)
    np.testing.assert_array_equal(got, jsvc.lookup(g, ln))
    np.testing.assert_array_equal(got, [exp[t] for t in tuples])
    # a repeat is pure cache: hits grow by the batch, misses do not
    h0, m0 = svc.cache.hits, svc.cache.misses
    np.testing.assert_array_equal(svc.lookup(g, ln), got)
    assert (svc.cache.hits, svc.cache.misses) == (h0 + len(tuples), m0)
    pool = [t[:-1] for t in tuples if len(t) >= 2][:10] + [(), (vocab + 1,)]
    pg = np.zeros((len(pool), sigma), np.int32)
    pl = np.zeros(len(pool), np.int32)
    for i, t in enumerate(pool):
        pg[i, :len(t)] = t
        pl[i] = len(t)
    np.testing.assert_array_equal(svc.continuations(pg, pl, k=4),
                                  jsvc.continuations(pg, pl, k=4))
    # ingest bumps the generation: stale entries are never served
    more = make_corpus(700, vocab, "zipf", 77)
    svc.ingest(more)
    jsvc.ingest(more)
    m1 = svc.cache.misses
    fresh = svc.lookup(g, ln)
    assert svc.cache.misses == m1 + len(tuples)
    exp2 = jstats_union(*[jrun(t, JConfig(**kw)) for t in slices + [more]]).to_dict()
    np.testing.assert_array_equal(fresh, [exp2[t] for t in tuples])
    np.testing.assert_array_equal(svc.continuations(pg, pl, k=4),
                                  jsvc.continuations(pg, pl, k=4))


def test_default_route_compacts_on_the_merge_route_as_kway_and_repro():
    """The port's default route is ``merge`` (``repro``'s is ``kway``, which in
    the port folds on the host); a default service's compacted rung equals an
    explicit ``kway`` service's and ``repro``'s default service's."""
    from repro_torch.index import GenerationalIndex
    from test_torch_compress import assert_same_compressed
    from test_torch_merge import assert_tensors_equal
    vocab, sigma = 30, 3
    kw = dict(sigma=sigma, tau=1, vocab_size=vocab, combine_route="hash")
    assert GenerationalIndex(sigma=sigma, vocab_size=vocab, device="cpu").route == "merge"
    svc = StreamingNGramService(NGramConfig(**kw), compress=True, device="cpu")
    assert svc.gen.route == "merge"
    kway = StreamingNGramService(NGramConfig(**kw), compress=True, route="kway",
                                 device="cpu")
    jsvc = JService(JConfig(**kw), compress=True)
    assert jsvc.gen.route == "kway"
    for i in range(4):
        toks = make_corpus(600, vocab, "zipf", 90 + i)
        for s in (svc, kway, jsvc):
            s.ingest(toks)
    for s in (svc, kway, jsvc):
        s.gen.compact_all()
    (rung,), (kway_rung,), (jrung,) = (s.gen.segments for s in (svc, kway, jsvc))
    assert_tensors_equal(rung, kway_rung)
    assert_same_compressed(rung, jrung)


def test_unported_service_options_raise():
    """Every option of the service is ported: the wave ingest
    (``wave_tokens``) and the job across ranks (``mesh``), with waves or
    without, construct; a mesh of one rank ingests and answers as one
    device (the ranks themselves: ``tests/test_torch_mesh_waves.py``)."""
    import torch
    from repro_torch.launch.mesh import DataMesh
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    assert StreamingNGramService(cfg, wave_tokens=64, device="cpu").wave_tokens == 64
    one = DataMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    toks = np.asarray([1, 2, 0, 2, 1, 2], np.int32)
    g = np.asarray([[1, 2], [2, 1], [2, 0], [3, 3]], np.int32)
    ln = np.asarray([2, 2, 1, 2], np.int32)
    want = StreamingNGramService(cfg, device="cpu")
    want.ingest(toks)
    for kw in ({}, {"wave_tokens": 4}):
        svc = StreamingNGramService(cfg, mesh=one, device="cpu", **kw)
        svc.ingest(toks)
        np.testing.assert_array_equal(svc.lookup(g, ln), want.lookup(g, ln))
