"""The port's flat index and queries against ``repro.index`` on CPU.

Both packages build an index from the same job output; every array must be
equal, and ``lookup`` / ``continuations`` must give equal answers on hit,
miss, malformed and empty-prefix batches (those of ``tests/test_index.py``)
over a corpus of about 20k tokens.  An index built by ``repro`` and carried
across with ``index_from_arrays`` must answer the same in the port.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.core as jcore
import repro.index as jindex
from repro.core.stats import NGramConfig as JConfig
from repro.core.stats import NGramStats as JStats
from repro_torch.core import NGramConfig, NGramStats, oracle, run_job
from repro_torch.data import corpus
from repro_torch.index import (build_index, continuations, index_from_arrays,
                               lookup)

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

SIGMA, TAU = 4, 4
VOCAB = corpus.NYT.vocab_size
ARRAYS = ("section_start", "fanout", "cont_prefix", "cont_last", "cont_counts",
          "cont_fanout", "cont_cumsum")


def grams_matrix(gram_tuples, sigma):
    g = np.zeros((len(gram_tuples), sigma), np.int32)
    ln = np.zeros(len(gram_tuples), np.int32)
    for i, t in enumerate(gram_tuples):
        g[i, : len(t)] = t
        ln[i] = len(t)
    return g, ln


def jax_arrays(jidx) -> dict:
    out = {name: np.asarray(getattr(jidx, name)) for name in ARRAYS}
    out["keys"] = np.asarray(jidx.segment.keys)
    out["counts"] = np.asarray(jidx.segment.counts)
    return out


@pytest.fixture(scope="module")
def built():
    toks = corpus.zipf_corpus(20_000, corpus.NYT, seed=3, duplicate_frac=0.05)
    stats = run_job(toks, NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB),
                    device="cpu")
    jstats = jcore.run_job(toks, JConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB))
    idx = build_index(stats, vocab_size=VOCAB, device="cpu")
    jidx = jindex.build_index(jstats, vocab_size=VOCAB)
    carried = index_from_arrays(jax_arrays(jidx), sigma=jidx.sigma,
                                vocab_size=jidx.vocab_size,
                                fanout_shift=jidx.fanout_shift,
                                n_fanout=jidx.n_fanout, device="cpu")
    exp = oracle.ngram_counts(toks, SIGMA, TAU)
    return dict(stats=stats, jstats=jstats, idx=idx, jidx=jidx,
                carried=carried, exp=exp)


def test_job_output_matches(built):
    np.testing.assert_array_equal(built["stats"].grams, built["jstats"].grams)
    np.testing.assert_array_equal(built["stats"].counts, built["jstats"].counts)
    assert built["stats"].counters == built["jstats"].counters


def test_every_index_array_matches(built):
    idx, jidx = built["idx"], built["jidx"]
    assert (idx.sigma, idx.vocab_size, idx.size, idx.fanout_shift, idx.n_fanout) \
        == (jidx.sigma, jidx.vocab_size, jidx.size, jidx.fanout_shift,
            jidx.n_fanout)
    assert idx.n_rows == jidx.n_rows == len(built["exp"])
    for name, want in jax_arrays(jidx).items():
        got = idx.segment.keys if name == "keys" else \
            idx.segment.counts if name == "counts" else getattr(idx, name)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=name)


def _query_batches(exp, sigma, vocab):
    rng = np.random.default_rng(0)
    hits = grams_matrix(sorted(exp), sigma)
    n = 3000
    ln = rng.integers(1, sigma + 1, n).astype(np.int32)
    g = rng.integers(1, vocab + 1, (n, sigma)).astype(np.int32)
    g *= np.arange(sigma)[None, :] < ln[:, None]
    malformed = (np.array([[0] * sigma, [vocab + 1] + [0] * (sigma - 1),
                           [1, 0] + [2] * (sigma - 2), [1] * sigma,
                           [-3] + [0] * (sigma - 1)], np.int32),
                 np.array([0, 1, 3, sigma + 1, 1], np.int32))
    return {"hits": hits, "misses": (g, ln), "malformed": malformed}


@pytest.mark.parametrize("which", ["idx", "carried"])
@pytest.mark.parametrize("batch", ["hits", "misses", "malformed"])
def test_lookup_matches_repro_and_oracle(built, which, batch):
    exp, jidx = built["exp"], built["jidx"]
    g, ln = _query_batches(exp, SIGMA, VOCAB)[batch]
    got = lookup(built[which], g, ln).numpy()
    np.testing.assert_array_equal(got, np.asarray(jindex.lookup(jidx, g, ln)))
    np.testing.assert_array_equal(
        got, np.asarray(jindex.lookup(jidx, g, ln, use_kernels=True)))
    if batch != "malformed":
        want = [exp.get(tuple(int(x) for x in r[:l]), 0) for r, l in zip(g, ln)]
        np.testing.assert_array_equal(got, want)
    else:
        assert got.tolist() == [0] * len(ln)


@pytest.mark.parametrize("which", ["idx", "carried"])
def test_continuations_match_repro_and_oracle(built, which):
    exp, jidx = built["exp"], built["jidx"]
    rng = np.random.default_rng(1)
    pool = [g[:-1] for g in exp if len(g) >= 2]
    prefixes = [()] + [pool[i] for i in rng.choice(len(pool), 60)] + [(7, 7, 7)]
    pg, pl = grams_matrix(prefixes, SIGMA)
    # malformed prefixes too: too long, negative length, out-of-vocab term
    pg = np.concatenate([pg, [[1, 2, 3, 4], [1, 0, 0, 0], [VOCAB + 1, 0, 0, 0]]])
    pl = np.concatenate([pl, [SIGMA, -1, 1]]).astype(np.int32)
    got = [x.numpy() for x in continuations(built[which], pg, pl, k=8)]
    for kernels in (False, True):
        want = jindex.continuations(jidx, pg, pl, k=8, use_kernels=kernels)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    nd, total, terms, counts = got
    for i, p in enumerate(prefixes):
        ext = {g[-1]: c for g, c in exp.items()
               if len(g) == len(p) + 1 and g[: len(p)] == p}
        assert nd[i] == len(ext), p
        assert total[i] == sum(ext.values()), p
        assert [int(c) for c in counts[i] if c > 0] == \
            sorted(ext.values(), reverse=True)[:8], p
    assert nd[-3:].tolist() == [0, 0, 0]


def test_empty_and_tiny_index():
    empty = NGramStats(np.zeros((0, 3), np.int32), np.zeros(0, np.int32),
                       np.zeros(0, np.int64))
    idx = build_index(empty, vocab_size=10, device="cpu")
    jidx = jindex.build_index(JStats(empty.grams, empty.lengths, empty.counts),
                              vocab_size=10)
    for name, want in jax_arrays(jidx).items():
        got = idx.segment.keys if name == "keys" else \
            idx.segment.counts if name == "counts" else getattr(idx, name)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64),
                                      err_msg=name)
    g, ln = grams_matrix([(1,), (1, 2)], 3)
    assert lookup(idx, g, ln).tolist() == [0, 0]
    nd, _, _, _ = continuations(idx, g, np.zeros(2, np.int32), k=2)
    assert nd.tolist() == [0, 0]
    one = NGramStats(np.array([[5, 0, 0]], np.int32), np.array([1], np.int32),
                     np.array([7], np.int64))
    idx1 = build_index(one, vocab_size=10, device="cpu")
    g, ln = grams_matrix([(5,), (6,)], 3)
    assert lookup(idx1, g, ln).tolist() == [7, 0]


def test_continuation_mass_overflow_refused():
    """Total continuation mass past uint32 raises in both packages."""
    big = NGramStats(np.array([[1, 0], [2, 0]], np.int32),
                     np.array([1, 1], np.int32),
                     np.array([2**31, 2**31], np.int64))
    with pytest.raises(ValueError, match="overflows"):
        build_index(big, vocab_size=3, device="cpu")
    with pytest.raises(ValueError, match="overflows"):
        jindex.build_index(JStats(big.grams, big.lengths, big.counts),
                           vocab_size=3)
