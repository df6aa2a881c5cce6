"""The port's extensions of the paper (SSV-SSVI) against ``repro`` on CPU.

Time series (bucketed SUFFIX-sigma jobs, ``run_counts_matrix``, the
``suffix_pack`` meta column), maximal / closed filtering, document
frequencies, postings, the two-phase sigma split and the term dictionary:
the same inputs, drawn with numpy from a seed, go through ``repro`` and
through the port with ``device="cpu"``, and every output (arrays, counters
and their types, dicts) must be equal, and equal to the pure-Python oracle
where it has one.  Every output is an integer count or index, so there is
no tolerance.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax
import jax.numpy as jnp

import repro.core as jcore
from repro.core import aggregations as jagg
from repro.core import extensions as jext
from repro.core import suffix_sigma as jsuffix_sigma
from repro.core.stats import NGramConfig as JConfig
from repro.mapreduce import segment as jsegment
from repro.pipeline import stages as jstages
from repro_torch import u32_words
from repro_torch.core import (NGramConfig, aggregations, extensions_filter, oracle,
                              run_job, suffix_sigma)
from repro_torch.data import corpus
from repro_torch.mapreduce import pack, segment
from repro_torch.pipeline import stages

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)


def assert_same_stats(got, want):
    np.testing.assert_array_equal(got.grams, want.grams)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == want.counts.dtype
    assert got.counters == want.counters
    assert {k: type(v) for k, v in got.counters.items()} == \
        {k: type(v) for k, v in want.counters.items()}


def series_corpus(seed):
    """A token stream with PAD separators, its bucket ids and (sigma, tau,
    vocab, n_buckets), drawn like ``test_core_methods.py``'s corpora."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 400))
    v = int(rng.integers(2, 40))
    toks = rng.integers(0, v + 1, n).astype(np.int32)
    b = int(rng.integers(1, 6))
    years = rng.integers(0, b, n).astype(np.int32)
    return toks, years, int(rng.integers(1, 6)), int(rng.integers(1, 4)), v, b


# ----------------------------------------------------------- series modules
@pytest.mark.parametrize("seed", range(4))
def test_make_records_with_buckets_matches_repro(seed):
    """lanes | weight | bucket, with bucket ids past 2**31 and negative ones
    read as uint32, as ``repro``'s ``astype(uint32)`` reads them."""
    toks, years, sigma, _, v, _ = series_corpus(seed)
    years = years.astype(np.int64)
    years[::7] = -3
    years[3::11] = 2**31 + 5
    records, valid = suffix_sigma.make_records(
        torch.as_tensor(toks), sigma=sigma, vocab_size=v,
        bucket_ids=u32_words(years, "cpu"))
    want, jvalid = jsuffix_sigma.make_records(
        jnp.asarray(toks), sigma=sigma, vocab_size=v,
        bucket_ids=jnp.asarray(years.astype(np.uint32)))
    assert records.shape == (len(toks), pack.n_lanes(sigma, v) + 2)
    np.testing.assert_array_equal(records.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("seed", range(4))
def test_run_counts_matrix_matches_repro(seed):
    """Per-(row, length, bucket) run totals against ``repro``'s one-hot
    form; buckets past ``n_buckets`` count nowhere."""
    rng = np.random.default_rng(seed)
    n, length, b = int(rng.integers(1, 300)), int(rng.integers(1, 7)), int(rng.integers(1, 5))
    terms = rng.integers(0, 4, (n, length)).astype(np.int32)
    terms = terms[np.lexsort(terms.T[::-1])]
    lcp = jsegment.lcp_lengths(jnp.asarray(terms))
    flags = np.array(jsegment.boundary_flags(jnp.asarray(terms), lcp))
    weights = rng.integers(0, 5, n).astype(np.int32)
    buckets = rng.integers(0, b + 2, n)
    wmat = jax.nn.one_hot(jnp.asarray(buckets), b, dtype=jnp.int32) * jnp.asarray(weights)[:, None]
    want = jsegment.run_counts_matrix(jnp.asarray(flags), jnp.asarray(terms != 0), wmat,
                                      max_segments=n)
    got = segment.run_counts_matrix(torch.as_tensor(flags), torch.as_tensor(terms != 0),
                                    torch.as_tensor(weights.astype(np.int64)),
                                    torch.as_tensor(buckets), b, max_segments=n)
    assert got.shape == (n, length, b) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_reduce_suffix_with_buckets_matches_repro(seed, use_kernels):
    """The reducer on sorted bucketed records: terms, flags and the
    [N, sigma, B] counts, against ``repro``'s jnp path and its Pallas
    ``lcp_boundary`` (interpret mode)."""
    toks, years, sigma, _, v, b = series_corpus(seed)
    rec, _ = suffix_sigma.make_records(torch.as_tensor(toks), sigma=sigma, vocab_size=v,
                                       bucket_ids=u32_words(years, "cpu"))
    n_l = pack.n_lanes(sigma, v)
    srt = stages.sort_stage(stages.combine(rec, n_l, True), n_keys=n_l)
    got = stages.reduce_suffix(srt, sigma=sigma, vocab_size=v, n_buckets=b)
    want = jstages.reduce_suffix(jnp.asarray(srt.numpy().astype(np.uint32)), sigma=sigma,
                                 vocab_size=v, n_buckets=b, use_kernels=use_kernels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("route", ["sort", "hash"])
def test_combine_keeps_buckets_apart_as_repro(route):
    """Both combiners key on lanes | bucket and leave the layout lanes |
    weight | bucket."""
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 3, 2000).astype(np.int32)
    years = rng.integers(0, 3, 2000).astype(np.int32)
    rec, _ = suffix_sigma.make_records(torch.as_tensor(toks), sigma=3, vocab_size=2,
                                       bucket_ids=u32_words(years, "cpu"))
    jrec = jnp.asarray(rec.numpy().astype(np.uint32))
    got = stages.combine(rec.clone(), 1, True, route=route)
    want = np.asarray(jstages.combine(jrec, 1, True, route=route)).astype(np.int64)
    if route == "hash":             # row order never changes
        np.testing.assert_array_equal(got.numpy(), want)
    else:                           # repro sorts unstably: compare the row multisets
        key = lambda a: a[np.lexsort(a.T[::-1])]                     # noqa: E731
        np.testing.assert_array_equal(key(got.numpy()), key(want))


# ------------------------------------------------------------ series jobs
@pytest.mark.parametrize("route", ["sort", "hash"])
@pytest.mark.parametrize("seed", range(4))
def test_series_job_matches_repro_and_oracle(seed, route):
    """``run_job(..., bucket_ids=)`` on both combine routes: grams, [R, B]
    series, every counter (``shuffle_bytes`` counts the bucket lane), and
    ``to_series_dict`` against ``oracle.ngram_series``."""
    toks, years, sigma, tau, v, b = series_corpus(seed)
    kw = dict(sigma=sigma, tau=tau, vocab_size=v, n_buckets=b, combine_route=route,
              pack=bool(seed % 2))
    got = run_job(toks, NGramConfig(**kw), bucket_ids=years, device="cpu")
    want = jcore.run_job(toks, JConfig(**kw, use_kernels=bool(seed // 2)), bucket_ids=years)
    assert_same_stats(got, want)
    exp = oracle.ngram_series(toks, years, sigma, tau, b)
    series = got.to_series_dict()
    assert series.keys() == exp.keys()
    for g, c in exp.items():
        np.testing.assert_array_equal(series[g], c)


@pytest.mark.parametrize("route", ["sort", "hash"])
def test_series_zipf_corpus_with_years_matches_repro(route):
    """The deployment of ``repro``'s ``ngram --series`` at a small size:
    the NYT profile with a year bucket a document, 21 buckets."""
    toks, years = corpus.zipf_corpus(4000, corpus.NYT, seed=2, duplicate_frac=0.02,
                                     with_years=True)
    kw = dict(sigma=5, tau=3, vocab_size=corpus.NYT.vocab_size, n_buckets=21,
              combine_route=route)
    got = run_job(toks, NGramConfig(**kw), bucket_ids=years, device="cpu")
    assert_same_stats(got, jcore.run_job(toks, JConfig(**kw), bucket_ids=years))
    plain = run_job(toks, NGramConfig(sigma=5, tau=3, vocab_size=corpus.NYT.vocab_size),
                    device="cpu")
    np.testing.assert_array_equal(got.grams, plain.grams)
    np.testing.assert_array_equal(got.counts.sum(axis=1), plain.counts)
    assert got.counters["map_records"] == plain.counters["map_records"]
    assert got.counters["shuffle_records"] >= plain.counters["shuffle_records"]
    assert got.counters["shuffle_bytes"] == got.counters["shuffle_records"] * 4 * (
        pack.n_lanes(5, corpus.NYT.vocab_size) + 2)


def test_bucket_ids_belong_to_suffix_sigma_alone():
    """As in ``repro``: the other methods take no ``bucket_ids``, and a
    series job needs them."""
    toks = np.asarray([1, 2, 0, 2, 1], np.int32)
    years = np.zeros(5, np.int32)
    for method in ("naive", "apriori_scan", "apriori_index"):
        with pytest.raises(TypeError):
            run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3, method=method),
                    bucket_ids=years, device="cpu")
        with pytest.raises(TypeError):
            jcore.run_job(toks, JConfig(sigma=2, tau=1, vocab_size=3, method=method),
                          bucket_ids=years)
    with pytest.raises(ValueError):
        run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3, n_buckets=2), device="cpu")
    with pytest.raises(ValueError):
        run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3, n_buckets=2),
                bucket_ids=years[:4], device="cpu")
    plain = run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3), device="cpu")
    with pytest.raises(ValueError):
        plain.to_series_dict()


# ---------------------------------------------------- maximal / closed grams
@pytest.mark.parametrize("mode", ["max", "closed"])
@pytest.mark.parametrize("seed,vocab,sigma,tau,n", [
    (2, 30, 5, 3, 800),
    (3, 2, 4, 1, 200),       # tau=1: everything frequent, worst-case overlap
])
def test_filter_stats_matches_repro_and_oracle(seed, vocab, sigma, tau, n, mode):
    """Two of the corpora of ``test_extensions.py``: the port's filter of the
    port's job equals ``repro``'s filter of ``repro``'s job, and the oracle's
    brute-force maximal / closed sets; maximal grams are closed."""
    toks = np.random.default_rng(seed).integers(0, vocab + 1, n)
    kw = dict(sigma=sigma, tau=tau, vocab_size=vocab)
    stats = run_job(toks, NGramConfig(**kw), device="cpu")
    got = extensions_filter(stats, mode, device="cpu")
    assert_same_stats(got, jext.filter_stats(jcore.run_job(toks, JConfig(**kw)), mode))
    exp = oracle.ngram_counts(toks, sigma, tau)
    want = oracle.maximal_ngrams(exp) if mode == "max" else oracle.closed_ngrams(exp)
    assert got.to_dict() == want
    if mode == "max":
        assert set(want) <= set(extensions_filter(stats, "closed", device="cpu").to_dict())


def test_filter_stats_handcrafted_runs():
    """"1 2 3" repeated: every proper sub-gram has a frequent extension with
    the same count, so only the full window survives either filter."""
    toks = np.array(([1, 2, 3] * 10 + [0]) * 3).ravel()
    stats = run_job(toks, NGramConfig(sigma=3, tau=2, vocab_size=3), device="cpu")
    exp = oracle.ngram_counts(toks, 3, 2)
    for mode, want in (("closed", oracle.closed_ngrams(exp)),
                       ("max", oracle.maximal_ngrams(exp))):
        got = extensions_filter(stats, mode, device="cpu")
        assert got.to_dict() == want
        assert (1, 2, 3) in want and (1, 2) not in want
        assert_same_stats(got, jext.filter_stats(
            jcore.run_job(toks, JConfig(sigma=3, tau=2, vocab_size=3)), mode))


@pytest.mark.parametrize("mode", ["max", "closed"])
def test_filter_stats_on_series_output_matches_repro(mode):
    """A series job's rows are filtered by their summed counts and keep their
    [B] series, as in ``repro``."""
    toks, years, sigma, tau, v, b = series_corpus(5)
    kw = dict(sigma=sigma, tau=tau, vocab_size=v, n_buckets=b)
    got = extensions_filter(run_job(toks, NGramConfig(**kw), bucket_ids=years,
                                    device="cpu"), mode, device="cpu")
    want = jext.filter_stats(jcore.run_job(toks, JConfig(**kw), bucket_ids=years), mode)
    assert got.counts.ndim == 2
    assert_same_stats(got, want)


def test_reverse_grams_matches_repro():
    from repro_torch.core import extensions
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 7, 200).astype(np.int32)
    grams = rng.integers(1, 50, (200, 6)).astype(np.int32)
    grams *= np.arange(6)[None, :] < lengths[:, None]
    got = extensions._reverse_grams(grams, lengths)
    np.testing.assert_array_equal(got, jext._reverse_grams(grams, lengths))
    assert got.dtype == grams.dtype


# ----------------------------------------------------------- aggregations
def test_doc_ids_from_stream_matches_repro():
    toks = np.asarray([0, 0, 3, 1, 0, 0, 2, 0, 5, 5, 0], np.int32)
    rand = np.random.default_rng(2).integers(0, 3, 500).astype(np.int32)
    for t in (toks, toks[2:], np.zeros(4, np.int32), np.asarray([7], np.int32), rand):
        got = aggregations.doc_ids_from_stream(t)
        np.testing.assert_array_equal(got, jagg.doc_ids_from_stream(t))
        assert got.dtype == np.int32


def df_corpus(seed):
    """The corpora of ``test_aggregations.py``'s df test: tokens, sigma, tau."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 25, int(rng.integers(40, 250)))
    return toks, int(rng.integers(1, 5)), int(rng.integers(1, 3))


@pytest.mark.parametrize("seed", range(3))
def test_document_frequencies_match_repro_and_oracle(seed):
    """One-job df (rows in ``repro``'s order, counters included) and the
    per-length df against the oracle."""
    toks, sigma, tau = df_corpus(seed)
    exp = oracle.ngram_document_frequencies(toks, sigma, tau)
    cfg = NGramConfig(sigma=sigma, tau=tau, vocab_size=24)
    got = aggregations.document_frequencies(toks, cfg, device="cpu")
    assert_same_stats(got, jagg.document_frequencies(
        toks, JConfig(sigma=sigma, tau=tau, vocab_size=24)))
    assert got.to_dict() == exp
    assert aggregations.df_suffix_lengths(toks, cfg, device="cpu").to_dict() == exp


def test_df_suffix_lengths_matches_repro():
    """The per-length df's rows and counters (``jobs`` = sigma) as
    ``repro``'s, on the first df corpus."""
    toks, sigma, tau = df_corpus(0)
    got = aggregations.df_suffix_lengths(
        toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=24), device="cpu")
    assert_same_stats(got, jagg.df_suffix_lengths(
        toks, JConfig(sigma=sigma, tau=tau, vocab_size=24)))
    assert got.counters["jobs"] == sigma


def test_df_bounded_by_cf():
    toks = np.random.default_rng(7).integers(0, 12, 400)
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=11)
    cf = run_job(toks, cfg, device="cpu").to_dict()
    df = aggregations.document_frequencies(toks, cfg, device="cpu").to_dict()
    assert set(df) == set(cf)
    for g, d in df.items():
        assert d <= cf[g]            # df(s) <= cf(s), SSII


@pytest.mark.parametrize("seed", range(3))
def test_postings_match_repro_and_oracle(seed):
    rng = np.random.default_rng(seed + 10)
    toks = rng.integers(0, 20, int(rng.integers(40, 200)))
    sigma, tau = int(rng.integers(1, 4)), int(rng.integers(1, 3))
    got = aggregations.postings(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=19),
                                device="cpu")
    assert got == jagg.postings(toks, JConfig(sigma=sigma, tau=tau, vocab_size=19))
    assert got == oracle.ngram_postings(toks, sigma, tau)
    assert all(type(d) is int and type(c) is int for p in got.values() for d, c in p.items())


def test_postings_marginalize_to_cf():
    toks = np.random.default_rng(3).integers(0, 15, 300)
    cfg = NGramConfig(sigma=3, tau=2, vocab_size=14)
    cf = run_job(toks, cfg, device="cpu").to_dict()
    post = aggregations.postings(toks, cfg, device="cpu")
    assert {g: sum(p.values()) for g, p in post.items()} == cf


# ------------------------------------------------------------- sigma split
@pytest.mark.parametrize("sigma_head,frac", [(6, 1 / 8), (4, 1 / 512), (20, 1 / 8)])
def test_sigma_split_matches_repro_and_full_job(sigma_head, frac):
    """The corpus of ``test_distributed.py::test_sigma_split_exact``: sigma
    20, heads 6 and 4, survivor fractions 1/8 and 1/512 (its buffer
    overflows, so the retry runs), and a head as long as sigma (one job)."""
    toks = corpus.zipf_corpus(3000, corpus.NYT, seed=5, duplicate_frac=0.3)
    kw = dict(sigma=20, tau=2, vocab_size=corpus.NYT.vocab_size)
    got = suffix_sigma.sigma_split(toks, NGramConfig(**kw), sigma_head, frac, device="cpu")
    assert_same_stats(got, jsuffix_sigma.sigma_split(toks, JConfig(**kw), sigma_head, frac))
    assert got.to_dict() == run_job(toks, NGramConfig(**kw), device="cpu").to_dict()
    if frac == 1 / 512:             # the first survivor buffer overflowed
        assert got.counters["phase_b_records"] > max(64, int(len(toks) * frac))


def test_sigma_split_without_frequent_heads_returns_phase_a():
    toks = np.arange(1, 41, dtype=np.int32)          # every gram once
    kw = dict(sigma=8, tau=2, vocab_size=40)
    got = suffix_sigma.sigma_split(toks, NGramConfig(**kw), 3, device="cpu")
    assert_same_stats(got, jsuffix_sigma.sigma_split(toks, JConfig(**kw), 3))
    assert len(got) == 0 and got.grams.shape[1] == 3


# --------------------------------------------------------- term dictionary
def test_term_dictionary_matches_repro():
    from repro.data import tokenizer as jtok
    from repro_torch.data import tokenizer
    text = ("The cat sat. The cat ran! Did the dog see the cat? "
            "\"Yes,\" said (the) dog; the end.")
    docs = tokenizer.sentences(text)
    assert docs == jtok.sentences(text)
    d, jd = tokenizer.TermDictionary.build(docs), jtok.TermDictionary.build(docs)
    assert d.id_to_term == jd.id_to_term and d.vocab_size == jd.vocab_size
    ids = d.encode(docs)
    np.testing.assert_array_equal(ids, jd.encode(docs))
    assert ids.dtype == np.int32
    assert d.decode_gram(ids[:4]) == jd.decode_gram(ids[:4]) == ("the", "cat", "sat")
    stats = run_job(ids, NGramConfig(sigma=2, tau=2, vocab_size=d.vocab_size), device="cpu")
    assert {d.decode_gram(g[:ln]) for g, ln in zip(stats.grams, stats.lengths)} >= \
        {("the",), ("the", "cat"), ("cat",)}
