"""The port's paths on the card against the same calls on the CPU.

Each case draws a corpus from ``repro_torch.data.corpus`` with a seed, runs
one path of the port on the card and on ``device="cpu"`` (the kernels'
plain versions), and requires every output to be equal: the four n-gram
methods, ``decode_segment`` of a compressed index, ``merge_segments`` on the
``"merge"`` route, and a compressed ``GenerationalIndex`` through its
compactions.  The file imports no JAX: it runs on a GPU host that has none,
and every case skips without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import METHODS, NGramConfig, run_job
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
