"""The port's segment merge and generational index against ``repro.index.merge``
on CPU.

``merge_segments`` on every route must equal ``repro``'s merge; merged
indexes of both layouts must equal a build of the union, array for array; the
uint32 overflow guard must raise; and a generational index fed the same job
deltas must make the same merges, hold rungs of the same sizes and kinds, and
answer lookups and continuations as ``repro``'s does.  Exact throughout.
"""
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.index as jindex
from repro.core import run_job as jrun
from repro.core.stats import NGramConfig as JConfig
from repro.core.stats import NGramStats as JStats
from repro.index.build import segment_from_stats as jsegment_from_stats
from repro_torch.core import NGramConfig, NGramStats, run_job
from repro_torch.index import (CompressedNGramIndex, GenerationalIndex,
                               NGramIndex, build_compressed_index, build_index,
                               continuations, generational_from_stats, lookup,
                               merge_indexes, merge_segments, segment_from_stats,
                               segment_to_stats, stats_union)
from repro_torch.index import compress as tcompress
from repro_torch.index import merge as tmerge
import test_compress
from test_compress import make_corpus

# ``test_merge`` imports ``tests.test_compress``; where an installed package
# named ``tests`` shadows this folder, that name is bound to the module above
sys.modules.setdefault("tests.test_compress", test_compress)
from test_merge import MERGE_DRAWS

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

ROUTES = ("kway", "merge", "device", "sort")


def jobs(vocab, dist, sigma, tau, seeds, n=2500):
    """(port stats, repro stats) of one corpus per seed."""
    out = []
    for s in seeds:
        toks = make_corpus(n, vocab, dist, s)
        out.append((run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab),
                            device="cpu"),
                    jrun(toks, JConfig(sigma=sigma, tau=tau, vocab_size=vocab))))
    return out


def assert_tensors_equal(a, b):
    """Every tensor field of two port index objects (dataclasses) is equal."""
    assert type(a) is type(b)
    for name, x in vars(a).items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        elif hasattr(x, "__dataclass_fields__"):
            assert_tensors_equal(x, y)
        else:
            assert x == y, name


def grams_matrix(tuples, sigma):
    g = np.zeros((len(tuples), sigma), np.int32)
    ln = np.zeros(len(tuples), np.int32)
    for i, t in enumerate(tuples):
        g[i, :len(t)] = t
        ln[i] = len(t)
    return g, ln


@pytest.mark.parametrize("vocab,dist,sigma,tau,seed", MERGE_DRAWS)
def test_merge_segments_every_route_matches_repro(vocab, dist, sigma, tau, seed):
    pairs = jobs(vocab, dist, sigma, tau, (seed, seed + 1000))
    segs = [segment_from_stats(p, vocab_size=vocab, device="cpu") for p, _ in pairs]
    want = jindex.merge_segments([jsegment_from_stats(j, vocab_size=vocab)
                                  for _, j in pairs])
    for route in ROUTES:
        got = merge_segments(segs, route=route)
        np.testing.assert_array_equal(got.keys.numpy(),
                                      np.asarray(want.keys).astype(np.int64), route)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts).astype(np.int64), route)


def test_merge_indexes_equal_union_build():
    """Three inputs plus an empty one, both layouts: merge == build(union)."""
    vocab, sigma = 40, 4
    pairs = jobs(vocab, "zipf", sigma, 1, (1, 2, 3), n=1200)
    empty = NGramStats(np.zeros((0, sigma), np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.int64))
    stats = [p for p, _ in pairs] + [empty]
    union = stats_union(*stats)
    np.testing.assert_array_equal(
        union.counts, jindex.stats_union(*[j for _, j in pairs]).counts)
    want = build_index(union, vocab_size=vocab, device="cpu")
    for route in ROUTES:
        got = merge_indexes([build_index(s, vocab_size=vocab, device="cpu")
                             for s in stats], route=route)
        assert_tensors_equal(got, want)
    cwant = build_compressed_index(union, vocab_size=vocab, device="cpu")
    for route in ("kway", "merge"):
        cgot = merge_indexes([build_compressed_index(s, vocab_size=vocab, device="cpu")
                              for s in stats], route=route)
        assert_tensors_equal(cgot, cwant)
    assert segment_to_stats(want.segment).to_dict() == union.to_dict()


def test_merged_count_overflow_guard_raises():
    big = 2**31 + 5
    one = NGramStats(np.array([[7, 0, 0]], np.int32), np.array([1], np.int32),
                     np.array([big], np.int64))
    segs = [segment_from_stats(one, vocab_size=9, device="cpu") for _ in range(2)]
    for route in ROUTES:
        with pytest.raises(ValueError, match="overflow"):
            merge_segments(segs, route=route)
    cixs = [build_compressed_index(one, vocab_size=9, device="cpu") for _ in range(2)]
    for route in ("kway", "merge"):
        with pytest.raises(ValueError, match="overflow"):
            merge_indexes(cixs, route=route)
    small = NGramStats(np.array([[7, 0, 0]], np.int32), np.array([1], np.int32),
                       np.array([10], np.int64))
    seg = merge_segments([segs[0], segment_from_stats(small, vocab_size=9,
                                                      device="cpu")])
    assert int(seg.counts[0]) == big + 10
    with pytest.raises(ValueError):
        merge_segments([])
    with pytest.raises(ValueError):
        merge_segments(segs, route="bogus")


def test_device_route_falls_back_to_host_above_the_ceiling(monkeypatch):
    """Above ``repro``'s ``DEVICE_MERGE_MAX_ROWS`` its device route falls back
    to the host k-way fold; the port's has no ceiling and stays on the merge
    tree at any size, with the same answer."""
    import repro.index.merge as jmerge
    pairs = jobs(30, "zipf", 3, 1, (0, 1, 2), n=900)
    segs = [segment_from_stats(p, vocab_size=30, device="cpu") for p, _ in pairs]
    monkeypatch.setattr(jmerge, "DEVICE_MERGE_MAX_ROWS", 1)
    want = jindex.merge_segments([jsegment_from_stats(j, vocab_size=30)
                                  for _, j in pairs], route="device")
    assert not hasattr(tmerge, "DEVICE_MERGE_MAX_ROWS")

    def host_fold(_):
        raise AssertionError("the device route took the host fold")
    monkeypatch.setattr(tmerge, "_kway_fold_host", host_fold)
    got = merge_segments(segs, route="device")
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys).astype(np.int64))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts).astype(np.int64))
    assert torch.equal(got.keys, merge_segments(segs, route="merge").keys)


def test_compressed_merge_working_set_is_one_chunk(monkeypatch):
    vocab = 40
    (a, _), (b, _) = jobs(vocab, "zipf", 4, 1, (21, 1021), n=3000)
    ca, cb = (build_compressed_index(s, vocab_size=vocab, device="cpu") for s in (a, b))
    assert min(ca.n_rows, cb.n_rows) > 64
    monkeypatch.setattr(tcompress, "_DECODE_CHUNK_ROWS", 64)
    monkeypatch.setitem(tcompress._DECODE_WATERMARK, "rows", 0)
    got = merge_indexes([ca, cb], route="kway")
    assert 0 < tcompress._DECODE_WATERMARK["rows"] <= 64
    assert_tensors_equal(got, build_compressed_index(stats_union(a, b),
                                                     vocab_size=vocab, device="cpu"))


@pytest.mark.parametrize("compress,route", [(False, "merge"), (True, "merge"),
                                            (True, "kway")])
def test_generational_matches_repro(compress, route):
    """The scenario of ``tests/test_merge.py::drive_generational``: the same
    merges, rung sizes and rung kinds after every ingest, the same answers,
    and ``compact_all`` equal to a from-scratch build of the union."""
    vocab, sigma, tau = 40, 4, 1
    cfg, jcfg = (NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab),
                 JConfig(sigma=sigma, tau=tau, vocab_size=vocab))
    slices = [make_corpus(n, vocab, "zipf", 10 + i)
              for i, n in enumerate((4000, 900, 900, 900))]
    gen = GenerationalIndex(sigma=sigma, vocab_size=vocab, compress=compress,
                            route=route, device="cpu")
    jgen = jindex.GenerationalIndex(sigma=sigma, vocab_size=vocab,
                                    compress=compress, route=route)
    stats = []
    for toks in slices:
        stats.append(run_job(toks, cfg, device="cpu"))
        rep, jrep = gen.ingest(stats[-1]), jgen.ingest(jrun(toks, jcfg))
        assert (rep["merges"], rep["segment_rows"]) == (jrep["merges"],
                                                        jrep["segment_rows"])
        assert [type(ix).__name__ for ix in gen.segments] == \
            [type(ix).__name__ for ix in jgen.segments]
    assert gen.compaction_stats == jgen.compaction_stats
    assert gen.generation == jgen.generation and gen.n_segments >= 2
    union = stats_union(*stats)
    exp = union.to_dict()
    g, ln = grams_matrix(sorted(exp), sigma)
    rng = np.random.default_rng(0)
    lm = rng.integers(0, sigma + 2, 1500).astype(np.int32)
    gm = rng.integers(0, vocab + 2, (1500, sigma)).astype(np.int32)
    for gg, ll in ((g, ln), (gm, lm)):
        np.testing.assert_array_equal(lookup(gen, gg, ll).numpy(),
                                      np.asarray(jindex.lookup(jgen, gg, ll)))
    np.testing.assert_array_equal(lookup(gen, g, ln).numpy(),
                                  [exp[t] for t in sorted(exp)])
    pool = [t[:-1] for t in sorted(exp) if len(t) >= 2]
    pg, pl = grams_matrix([(), ()] + [pool[i] for i in rng.choice(len(pool), 25)]
                          + [(vocab + 2,)], sigma)
    for a, b in zip(continuations(gen, pg, pl, k=6),
                    jindex.continuations(jgen, pg, pl, k=6)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    gen.compact_all()
    assert gen.n_segments == 1
    build = build_compressed_index if compress else build_index
    assert_tensors_equal(gen.segments[0], build(union, vocab_size=vocab, device="cpu"))


@pytest.mark.parametrize("vocab,dist,sigma,tau,seed", [MERGE_DRAWS[1], MERGE_DRAWS[3]])
def test_mixed_stack_matches_flat_stack(vocab, dist, sigma, tau, seed):
    """A stack of a flat and a compressed rung answers as the all-flat stack,
    and as ``repro``'s mixed stack."""
    (sa, ja), (sb, jb) = jobs(vocab, dist, sigma, tau, (seed, seed + 1000), n=1500)
    flat = GenerationalIndex(sigma=sigma, vocab_size=vocab, device="cpu")
    flat.levels = [build_index(s, vocab_size=vocab, device="cpu") for s in (sb, sa)]
    mixed = GenerationalIndex(sigma=sigma, vocab_size=vocab, device="cpu")
    mixed.levels = [build_index(sb, vocab_size=vocab, device="cpu"),
                    build_compressed_index(sa, vocab_size=vocab, device="cpu")]
    jmixed = jindex.GenerationalIndex(sigma=sigma, vocab_size=vocab)
    jmixed.levels = [jindex.build_index(jb, vocab_size=vocab),
                     jindex.build_compressed_index(ja, vocab_size=vocab)]
    exp = stats_union(sa, sb).to_dict()
    rng = np.random.default_rng(11)
    tuples = sorted(exp)
    g, ln = grams_matrix([tuples[i] for i in rng.choice(len(tuples), 500)], sigma)
    miss_l = rng.integers(1, sigma + 1, 150).astype(np.int32)
    miss_g = rng.integers(1, vocab + 1, (150, sigma)).astype(np.int32)
    g, ln = np.concatenate([g, miss_g]), np.concatenate([ln, miss_l])
    got = lookup(mixed, g, ln).numpy()
    np.testing.assert_array_equal(got, lookup(flat, g, ln).numpy())
    np.testing.assert_array_equal(got, np.asarray(jindex.lookup(jmixed, g, ln)))
    pool = [t[:-1] for t in tuples if len(t) >= 2] or [()]
    pg, pl = grams_matrix([(), (vocab + 2,)] + [pool[i] for i in rng.choice(len(pool), 10)],
                          sigma)
    want = jindex.continuations(jmixed, pg, pl, k=5)
    for a, b, c in zip(continuations(mixed, pg, pl, k=5),
                       continuations(flat, pg, pl, k=5), want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_continuation_ladder_covers_wide_prefixes():
    """Prefixes whose continuation sets outgrow several fetch widths (the
    empty prefix over a wide vocabulary) fold exactly, duplicates included."""
    vocab, sigma = 300, 2
    pairs = jobs(vocab, "uniform", sigma, 1, (5, 6), n=3000)
    gen = GenerationalIndex(sigma=sigma, vocab_size=vocab, device="cpu")
    gen.levels = [build_index(p, vocab_size=vocab, device="cpu") for p, _ in pairs]
    jgen = jindex.GenerationalIndex(sigma=sigma, vocab_size=vocab)
    jgen.levels = [jindex.build_index(j, vocab_size=vocab) for _, j in pairs]
    pg, pl = grams_matrix([(), (3,), (), (7,), (vocab + 5,), (3,)], sigma)
    for a, b in zip(continuations(gen, pg, pl, k=4),
                    jindex.continuations(jgen, pg, pl, k=4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_generational_bootstrap_empty_and_guards():
    empty = GenerationalIndex(sigma=3, vocab_size=9, device="cpu")
    assert lookup(empty, np.zeros((2, 3), np.int32), np.ones(2, np.int32)).tolist() == [0, 0]
    nd, tot, terms, cfs = continuations(empty, np.zeros((2, 3), np.int32),
                                        np.zeros(2, np.int32), k=4)
    assert nd.tolist() == [0, 0] and terms.shape == (2, 4)
    s = NGramStats(np.array([[5, 0, 0]], np.int32), np.array([1], np.int32),
                   np.array([7], np.int64))
    gen = generational_from_stats(s, vocab_size=9, device="cpu")
    assert gen.n_segments == 1 and gen.generation == 1
    assert isinstance(gen.segments[0], NGramIndex)
    with pytest.raises(ValueError):          # sigma mismatch on ingest
        gen.ingest(NGramStats(np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.int64)))
    gen.ingest(NGramStats(np.zeros((0, 3), np.int32), np.zeros(0, np.int32),
                          np.zeros(0, np.int64)))
    assert gen.n_segments == 1 and gen.generation == 2
    # counts split across live rungs must not wrap at query time
    big = NGramStats(np.array([[7, 0, 0]], np.int32), np.array([1], np.int32),
                     np.array([2**31 + 5], np.int64))
    two = GenerationalIndex(sigma=3, vocab_size=9, size_ratio=1, device="cpu")
    two.levels = [build_index(big, vocab_size=9, device="cpu"),
                  build_compressed_index(big, vocab_size=9, device="cpu")]
    assert isinstance(two.segments[1], CompressedNGramIndex)
    with pytest.raises(ValueError, match="overflow"):
        lookup(two, np.array([[7, 0, 0]], np.int32), np.array([1], np.int32))
    with pytest.raises(ValueError, match="overflow"):
        continuations(two, np.zeros((1, 3), np.int32), np.zeros(1, np.int32), k=2)
    jtwo = jindex.GenerationalIndex(sigma=3, vocab_size=9)
    jtwo.levels = [jindex.build_index(JStats(big.grams, big.lengths, big.counts),
                                      vocab_size=9)] * 2
    with pytest.raises(ValueError, match="overflow"):
        jindex.lookup(jtwo, np.array([[7, 0, 0]], np.int32), np.array([1], np.int32))
