"""The port's paths on the card against the same calls on the CPU.

Each case draws a corpus from ``repro_torch.data.corpus`` with a seed, runs
one path of the port on the card and on ``device="cpu"`` (the kernels'
plain versions), and requires every output to be equal: the four n-gram
methods, ``decode_segment`` of a compressed index, ``merge_segments`` on the
``"merge"`` route, a compressed ``GenerationalIndex`` through its
compactions, and the paper's extensions (the time-series job on both
combine routes, maximal / closed filtering, document frequencies, postings
and the two-phase sigma split).  The file imports no JAX: it runs on a GPU host that has none,
and every case skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (METHODS, NGramConfig, aggregations, extensions_filter,
                              run_job, suffix_sigma)
from repro_torch.data import corpus
from repro_torch.index import (GenerationalIndex, build_compressed_index,
                               decode_segment, merge_segments, segment_from_stats)

SIGMA, TAU = 5, 2
VOCAB = corpus.NYT.vocab_size


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def draw(n: int, seed: int) -> np.ndarray:
    return corpus.zipf_corpus(n, corpus.NYT, seed=seed, duplicate_frac=0.05)


def cpu_stats(n: int, seed: int):
    return run_job(draw(n, seed), NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB),
                   device="cpu")


def assert_same_stats(got, want):
    for field in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.counters == want.counters


def assert_equal_on_host(a, b):
    """Every field of two port index objects (dataclasses) is equal, tensors
    compared on the host."""
    assert type(a) is type(b)
    for name, x in vars(a).items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), name
        elif hasattr(x, "__dataclass_fields__"):
            assert_equal_on_host(x, y)
        else:
            assert x == y, name


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_methods_match_cpu(cuda_device, method):
    """Grams, lengths, counts and every counter of each method's job."""
    toks = draw(40_000, 3)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method,
                      apriori_index_k=2)
    got = run_job(toks, cfg, device=cuda_device)
    want = run_job(toks, cfg, device="cpu")
    for field in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.counters == want.counters


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [4, 16])
def test_cuda_decode_segment_matches_cpu(cuda_device, block_size):
    stats = cpu_stats(30_000, 5)
    got = decode_segment(build_compressed_index(
        stats, vocab_size=VOCAB, block_size=block_size, device=cuda_device))
    want = decode_segment(build_compressed_index(
        stats, vocab_size=VOCAB, block_size=block_size, device="cpu"))
    assert_equal_on_host(got, want)


@pytest.mark.cuda
def test_cuda_merge_segments_matches_cpu(cuda_device):
    parts = [cpu_stats(n, seed) for n, seed in ((30_000, 6), (8_000, 7), (8_000, 8))]
    got = merge_segments([segment_from_stats(s, vocab_size=VOCAB, device=cuda_device)
                          for s in parts], route="merge")
    want = merge_segments([segment_from_stats(s, vocab_size=VOCAB, device="cpu")
                           for s in parts], route="merge")
    assert got.keys.is_cuda
    assert_equal_on_host(got, want)


@pytest.mark.cuda
def test_cuda_generational_compaction_matches_cpu(cuda_device):
    """The same merges and rungs after every ingest, and after
    ``compact_all``, on a compressed index with the default route."""
    gens = [GenerationalIndex(sigma=SIGMA, vocab_size=VOCAB, compress=True,
                              device=dev) for dev in (cuda_device, "cpu")]
    for i, n in enumerate((24_000, 6_000, 6_000, 6_000)):
        stats = cpu_stats(n, 10 + i)
        reports = [g.ingest(stats) for g in gens]
        assert reports[0] == reports[1]
        for a, b in zip(*(g.segments for g in gens)):
            assert_equal_on_host(a, b)
    for g in gens:
        g.compact_all()
    (got,), (want,) = (g.segments for g in gens)
    assert_equal_on_host(got, want)
    assert gens[0].compaction_stats == gens[1].compaction_stats


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sort", "hash"])
def test_cuda_series_job_matches_cpu(cuda_device, route):
    """``run_job(..., bucket_ids=)`` with 21 year buckets: the records'
    bucket column from ``suffix_pack``, the combiner keyed on lanes |
    bucket, and the per-bucket run totals."""
    toks, years = corpus.zipf_corpus(40_000, corpus.NYT, seed=3, duplicate_frac=0.05,
                                     with_years=True)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, n_buckets=21,
                      combine_route=route)
    got = run_job(toks, cfg, bucket_ids=years, device=cuda_device)
    assert got.counts.shape[1] == 21
    assert_same_stats(got, run_job(toks, cfg, bucket_ids=years, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["max", "closed"])
def test_cuda_filter_stats_matches_cpu(cuda_device, mode):
    stats = cpu_stats(40_000, 4)
    assert_same_stats(extensions_filter(stats, mode, device=cuda_device),
                      extensions_filter(stats, mode, device="cpu"))


@pytest.mark.cuda
def test_cuda_document_frequencies_and_postings_match_cpu(cuda_device):
    toks = draw(20_000, 6)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB)
    for fn in (aggregations.document_frequencies, aggregations.df_suffix_lengths):
        assert_same_stats(fn(toks, cfg, device=cuda_device), fn(toks, cfg, device="cpu"))
    assert aggregations.postings(toks, cfg, device=cuda_device) == \
        aggregations.postings(toks, cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_head,frac", [(16, 1 / 64), (4, 1 / 512)])
def test_cuda_sigma_split_matches_cpu(cuda_device, sigma_head, frac):
    """sigma 40 (the generic ``suffix_pack`` instance in the reference job),
    with and without the survivor buffer's retry."""
    toks = corpus.zipf_corpus(20_000, corpus.NYT, seed=7, duplicate_frac=0.3)
    cfg = NGramConfig(sigma=40, tau=TAU, vocab_size=VOCAB)
    got = suffix_sigma.sigma_split(toks, cfg, sigma_head, frac, device=cuda_device)
    assert_same_stats(got, suffix_sigma.sigma_split(toks, cfg, sigma_head, frac,
                                                    device="cpu"))
    assert got.to_dict() == run_job(toks, cfg, device=cuda_device).to_dict()
