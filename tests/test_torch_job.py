"""The port's SUFFIX-sigma job against ``repro.core.run_job`` on CPU.

Grams, lengths, counts and the full counter dict must be equal, compared at
``canonical_stats`` output (``repro``'s sort is unstable, so the dense
reducer arrays may order equal rows differently).  The corpora are the
paper's running example and the ``test_random_corpora_match_oracle`` corpora
of ``tests/test_core_methods.py``, with the combiner and packing on and off,
and ``repro`` run both through its jnp path and its Pallas kernels.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.core as jcore
from repro.core.stats import NGramConfig as JConfig
from repro_torch.core import NGramConfig, oracle, run_job

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

# paper running example, a=1 b=2 x=3
D1, D2, D3 = [1, 3, 2, 3, 3], [2, 1, 3, 2, 3], [3, 2, 1, 3, 2]
PAPER = np.asarray(D1 + [0] + D2 + [0] + D3, np.int32)

VARIANTS = [dict(combine=c, pack=p) for c in (True, False) for p in (True, False)]


def assert_same_stats(got, want):
    np.testing.assert_array_equal(got.grams, want.grams)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counters == want.counters
    assert {k: type(v) for k, v in got.counters.items()} == \
        {k: type(v) for k, v in want.counters.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paper_running_example(use_kernels):
    kw = dict(sigma=3, tau=3, vocab_size=3)
    got = run_job(PAPER, NGramConfig(**kw), device="cpu")
    assert got.to_dict() == {(1,): 3, (2,): 5, (3,): 7, (1, 3): 3, (3, 2): 4,
                             (1, 3, 2): 3}
    assert_same_stats(got, jcore.run_job(PAPER, JConfig(**kw,
                                                        use_kernels=use_kernels)))


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("seed", range(4))
def test_random_corpora_match_repro_and_oracle(seed, variant):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    v = int(rng.integers(2, 50))
    toks = rng.integers(0, v + 1, n)
    sigma = int(rng.integers(1, 7))
    tau = int(rng.integers(1, 4))
    kw = dict(sigma=sigma, tau=tau, vocab_size=v, **VARIANTS[variant])
    got = run_job(toks, NGramConfig(**kw), device="cpu")
    assert got.to_dict() == oracle.ngram_counts(toks, sigma, tau)
    # repro's jnp path and its Pallas kernels alternate over the grid, so
    # each (combine, pack) variant meets both
    want = jcore.run_job(toks, JConfig(**kw, use_kernels=bool((seed + variant) % 2)))
    assert_same_stats(got, want)


@pytest.mark.parametrize("variant", range(len(VARIANTS)))
@pytest.mark.parametrize("seed", range(4))
def test_make_records_matches_repro(seed, variant):
    """The map emit's records (lanes written in place, then the weight
    column) and valid mask equal ``repro``'s ``make_records`` on the corpora
    above, at the lane vocabulary each variant packs with."""
    import jax.numpy as jnp

    from repro.core import suffix_sigma as jsuffix_sigma
    from repro_torch.core import suffix_sigma
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    v = int(rng.integers(2, 50))
    toks = rng.integers(0, v + 1, n).astype(np.int32)
    sigma = int(rng.integers(1, 7))
    vocab = NGramConfig(sigma=sigma, tau=1, vocab_size=v, **VARIANTS[variant]).lane_vocab
    for t in (toks, PAPER):
        records, valid = suffix_sigma.make_records(torch.as_tensor(t), sigma=sigma,
                                                   vocab_size=vocab)
        want, jvalid = jsuffix_sigma.make_records(jnp.asarray(t), sigma=sigma,
                                                  vocab_size=vocab)
        np.testing.assert_array_equal(records.numpy(), np.asarray(want).astype(np.int64))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_hash_combiner_matches_repro(seed, pack):
    """``combine_route="hash"`` on the corpora above: equal grams, counts and
    counters -- ``shuffle_records`` counts the rows the lossy per-block
    combiner leaves, so it pins the block and slot rule."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    v = int(rng.integers(2, 50))
    toks = rng.integers(0, v + 1, n)
    sigma = int(rng.integers(1, 7))
    tau = int(rng.integers(1, 4))
    kw = dict(sigma=sigma, tau=tau, vocab_size=v, pack=pack, combine_route="hash")
    got = run_job(toks, NGramConfig(**kw), device="cpu")
    assert got.to_dict() == oracle.ngram_counts(toks, sigma, tau)
    assert_same_stats(got, jcore.run_job(toks, JConfig(**kw, use_kernels=bool(seed % 2))))


@pytest.mark.parametrize("seed", range(3))
def test_hash_combine_stage_rewrites_only_the_weights_in_place(seed):
    """``stages.combine_hash`` writes the combined weights into the records'
    own weight column (``out=``): the same matrix comes back, keys and row
    order untouched, the weights equal ``repro``'s combiner on ``repro``'s
    records, and the hash-route job still equals ``repro.core.run_job``."""
    import jax.numpy as jnp

    from repro.core import suffix_sigma as jsuffix_sigma
    from repro.kernels import ref as jref
    from repro_torch.core import suffix_sigma
    from repro_torch.mapreduce import pack
    from repro_torch.pipeline import stages
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 6, int(rng.integers(600, 3000))).astype(np.int32)
    sigma, vocab = 4, 5
    n_l = pack.n_lanes(sigma, vocab)
    records, _ = suffix_sigma.make_records(torch.as_tensor(toks), sigma=sigma,
                                           vocab_size=vocab)
    before = records.clone()
    assert stages.combine_hash(records, n_l) is records
    np.testing.assert_array_equal(records[:, :n_l].numpy(), before[:, :n_l].numpy())
    jrec, _ = jsuffix_sigma.make_records(jnp.asarray(toks), sigma=sigma, vocab_size=vocab)
    want = jref.hash_combine_ref(jrec[:, :n_l], jrec[:, n_l], block=256)
    np.testing.assert_array_equal(records[:, n_l].numpy(), np.asarray(want).astype(np.int64))
    assert int(records[:, n_l].sum()) == int((toks != 0).sum())
    kw = dict(sigma=sigma, tau=2, vocab_size=vocab, combine_route="hash")
    assert_same_stats(run_job(toks, NGramConfig(**kw), device="cpu"),
                      jcore.run_job(toks, JConfig(**kw)))


def test_hash_combiner_zipf_corpus_matches_repro():
    """Blocks of 256 rows with many equal suffixes (a Zipf corpus of 6000
    terms): the combiner removes rows, and the counters still agree."""
    from repro_torch.data import corpus
    toks = corpus.zipf_corpus(6000, corpus.NYT, seed=4, duplicate_frac=0.05)
    kw = dict(sigma=5, tau=3, vocab_size=corpus.NYT.vocab_size, combine_route="hash")
    got = run_job(toks, NGramConfig(**kw), device="cpu")
    want = jcore.run_job(toks, JConfig(**kw))
    assert_same_stats(got, want)
    assert got.counters["shuffle_records"] < got.counters["map_records"]


def test_zipf_corpus_matches_repro():
    from repro_torch.data import corpus
    toks = corpus.zipf_corpus(6000, corpus.NYT, seed=4, duplicate_frac=0.05)
    kw = dict(sigma=5, tau=3, vocab_size=corpus.NYT.vocab_size)
    assert_same_stats(run_job(toks, NGramConfig(**kw), device="cpu"),
                      jcore.run_job(toks, JConfig(**kw)))


def test_empty_and_degenerate_inputs():
    cfg = NGramConfig(sigma=3, tau=1, vocab_size=5)
    assert run_job(np.zeros(10, np.int32), cfg, device="cpu").to_dict() == {}
    assert run_job(np.asarray([2], np.int32), cfg, device="cpu").to_dict() == {(2,): 1}
    one = run_job(np.asarray([2, 2, 2], np.int32),
                  NGramConfig(sigma=2, tau=2, vocab_size=5), device="cpu")
    assert one.to_dict() == {(2,): 3, (2, 2): 2}
    assert_same_stats(run_job(np.zeros(10, np.int32), cfg, device="cpu"),
                      jcore.run_job(np.zeros(10, np.int32),
                                    JConfig(sigma=3, tau=1, vocab_size=5)))


def test_record_count_invariant():
    """SSIV: SUFFIX-sigma emits exactly one record per token occurrence."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 30, 1000)
    for sigma in (1, 3, 9):
        st = run_job(toks, NGramConfig(sigma=sigma, tau=5, vocab_size=29,
                                       combine=False), device="cpu")
        assert st.counters["map_records"] == int((toks != 0).sum())
        assert st.counters["shuffle_records"] == int((toks != 0).sum())


def test_unported_options_raise():
    toks = np.asarray([1, 2, 0, 2], np.int32)
    # series jobs run in the port; one without its bucket ids is refused
    with pytest.raises(ValueError):
        run_job(toks, NGramConfig(sigma=2, tau=1, vocab_size=3, n_buckets=2),
                device="cpu")
    # the service takes a mesh now; a mesh of one rank is one device
    import torch
    from repro_torch.launch.mesh import DataMesh
    from repro_torch.serve import StreamingNGramService
    cfg = NGramConfig(sigma=2, tau=1, vocab_size=3)
    one = DataMesh(rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    svc = StreamingNGramService(cfg, mesh=one, device="cpu")
    assert svc.mesh is one
    svc.ingest(toks)
    np.testing.assert_array_equal(
        svc.lookup(np.asarray([[1, 2], [2, 0], [2, 1]], np.int32), np.asarray([2, 1, 2])),
        [1, 2, 0])
