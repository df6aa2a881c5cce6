"""The port's four n-gram methods against ``repro.core.run_job`` on CPU, and
their modules against ``repro``'s functions.

Jobs: grams, lengths, counts, the whole counter dict and the counters'
types must be equal at ``canonical_stats`` output, on the paper's running
example and the ``tests/test_core_methods.py`` random corpora (tau = 1 draws
take the APRIORI carries' ``tau_eff == 1`` branch), with packing on and off.
Modules: ``kgram_records``, NAIVE's exploded emit, the APRIORI dictionary
(``membership_hashes``, ``member``) and ``reduce_exact`` on seeded numpy
inputs.  Every output is an integer, so every comparison is exact.  JAX is
imported on first use only: the ``cuda`` tests of this file, which compare
the card with the CPU, run on a GPU host that has no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import METHODS, NGramConfig, common, naive, oracle, run_job
from repro_torch.mapreduce import pack
from repro_torch.pipeline import stages

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

# paper running example, a=1 b=2 x=3
D1, D2, D3 = [1, 3, 2, 3, 3], [2, 1, 3, 2, 3], [3, 2, 1, 3, 2]
PAPER = np.asarray(D1 + [0] + D2 + [0] + D3, np.int32)


def _repro():
    """(repro.core, repro's NGramConfig), imported on demand."""
    import repro.core as jcore
    from repro.core.stats import NGramConfig as JConfig
    return jcore, JConfig


def assert_same_stats(got, want):
    np.testing.assert_array_equal(got.grams, want.grams)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counters == want.counters
    assert {k: type(v) for k, v in got.counters.items()} == \
        {k: type(v) for k, v in want.counters.items()}


def random_corpus(seed):
    """The corpus and (sigma, tau, vocab) of ``test_core_methods.py``'s draw."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(20, 400))
    v = int(rng.integers(2, 50))
    toks = rng.integers(0, v + 1, n)
    sigma = int(rng.integers(1, 7))
    tau = int(rng.integers(1, 4))
    return toks, sigma, tau, v


def lanes_input(rng, sigma, vocab):
    """A token stream with PAD runs, and the lane count of its packing."""
    n = int(rng.integers(1, 300))
    toks = rng.integers(0, vocab + 1, n).astype(np.int32)
    toks[rng.random(n) < 0.15] = 0
    return toks, pack.n_lanes(sigma, vocab)


# ------------------------------------------------------------------ the jobs
@pytest.mark.parametrize("method", sorted(METHODS))
def test_paper_running_example(method):
    jcore, JConfig = _repro()
    kw = dict(sigma=3, tau=3, vocab_size=3, method=method)
    got = run_job(PAPER, NGramConfig(**kw), device="cpu")
    assert got.to_dict() == {(1,): 3, (2,): 5, (3,): 7, (1, 3): 3, (3, 2): 4,
                             (1, 3, 2): 3}
    assert_same_stats(got, jcore.run_job(PAPER, JConfig(**kw)))


@pytest.mark.parametrize("pack_lanes", [True, False])
@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("seed", range(4))
def test_random_corpora_match_repro(seed, method, pack_lanes):
    """``test_core_methods.py::test_random_corpora_match_oracle``'s grid
    (``apriori_index_k`` 1-4, the combiner on and off), with ``pack`` on and
    off: the whole-gram plans pack at ``vocab_size`` whatever ``pack`` says,
    and ``shuffle_bytes`` must count the same lanes as ``repro``'s."""
    jcore, JConfig = _repro()
    toks, sigma, tau, v = random_corpus(seed)
    kw = dict(sigma=sigma, tau=tau, vocab_size=v, method=method,
              combine=bool(seed % 2), apriori_index_k=1 + seed % 4,
              pack=pack_lanes)
    got = run_job(toks, NGramConfig(**kw), device="cpu")
    assert got.to_dict() == oracle.ngram_counts(toks, sigma, tau)
    assert_same_stats(got, jcore.run_job(toks, JConfig(**kw)))


@pytest.mark.parametrize("method", ["naive", "apriori_scan", "apriori_index"])
def test_zipf_corpus_matches_repro(method):
    """A Zipf corpus at tau = 3: the APRIORI carries take their tau > 1
    branch (the host dictionary, the run totals scattered to positions) over
    several rounds, and APRIORI-INDEX joins from round 3 on."""
    from repro_torch.data import corpus
    jcore, JConfig = _repro()
    toks = corpus.zipf_corpus(6000, corpus.NYT, seed=4, duplicate_frac=0.05)
    kw = dict(sigma=5, tau=3, vocab_size=corpus.NYT.vocab_size, method=method,
              apriori_index_k=2)
    got = run_job(toks, NGramConfig(**kw), device="cpu")
    assert_same_stats(got, jcore.run_job(toks, JConfig(**kw)))
    assert got.counters["jobs"] == (1 if method == "naive" else 5)


def test_naive_record_count_matches_analysis():
    """NAIVE emits sum_{s: |s|<=sigma} cf(s) records (SSIII-A)."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 20, 500)
    sigma = 4
    st = run_job(toks, NGramConfig(sigma=sigma, tau=1, vocab_size=19,
                                   method="naive"), device="cpu")
    expected = oracle.expected_map_records(toks, sigma, "naive")
    assert st.counters["map_records"] == expected
    assert expected == sum(oracle.ngram_counts(toks, sigma, 1).values())


def test_apriori_scan_prunes_vs_naive():
    """Candidate records of APRIORI-SCAN never exceed NAIVE's emissions and the
    number of jobs is bounded by sigma (SSIII-B)."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 50, 800)
    sigma, tau = 5, 4
    scan = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=49,
                                     method="apriori_scan"), device="cpu")
    nv = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=49,
                                   method="naive"), device="cpu")
    assert scan.counters["map_records"] <= nv.counters["map_records"]
    assert scan.counters["jobs"] <= sigma
    assert scan.to_dict() == nv.to_dict()


@pytest.mark.parametrize("package", ["port", "repro"])
def test_unknown_method_raises_value_error(package):
    toks = np.asarray([1, 2, 3, 0, 1, 2], np.int32)
    kw = dict(sigma=3, tau=1, vocab_size=10, method="foo")
    if package == "port":
        call = lambda: run_job(toks, NGramConfig(**kw), device="cpu")  # noqa: E731
    else:
        jcore, JConfig = _repro()
        call = lambda: jcore.run_job(toks, JConfig(**kw))  # noqa: E731
    with pytest.raises(ValueError, match="unknown method 'foo'"):
        call()


def test_mesh_raises_for_every_method():
    """A mesh of two ranks whose process group was never started raises in
    every method (its first collective), rather than running on one device.
    The jobs across ranks themselves: ``tests/test_torch_distributed.py``."""
    from repro_torch.launch.mesh import DataMesh
    toks = np.asarray([1, 2, 0, 2], np.int32)
    mesh = DataMesh(rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for name in METHODS:
        with pytest.raises((RuntimeError, ValueError), match="process group"):
            METHODS[name](toks, NGramConfig(sigma=2, tau=1, vocab_size=3, method=name),
                          mesh=mesh, device="cpu")


# --------------------------------------------------------------- the modules
@pytest.mark.parametrize("vocab", [3, 50, 20_000, 1 << 30])
@pytest.mark.parametrize("seed", range(3))
def test_kgram_records_match_repro(seed, vocab):
    """Every k, with and without a weight mask and positions: the records and
    valid mask equal ``repro``'s row for row."""
    import jax.numpy as jnp

    from repro.core import common as jcommon
    rng = np.random.default_rng(seed)
    sigma = int(rng.integers(1, 9))
    toks, _ = lanes_input(rng, sigma, min(vocab, 1 << 20))
    mask = rng.random(toks.shape[0]) < 0.7
    for k in range(1, sigma + 1):
        for wm in (None, mask):
            for pos in (False, True):
                got, valid = common.kgram_records(
                    torch.as_tensor(toks), k, sigma, vocab,
                    weight_mask=None if wm is None else torch.as_tensor(wm),
                    with_positions=pos)
                want, jvalid = jcommon.kgram_records(
                    jnp.asarray(toks), k, sigma, vocab,
                    weight_mask=None if wm is None else jnp.asarray(wm),
                    with_positions=pos)
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(want).astype(np.int64))
                np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("vocab", [3, 20_000, 1 << 30])
@pytest.mark.parametrize("seed", range(3))
def test_explode_matches_repro(seed, vocab):
    """NAIVE's exploded emit: the same multiset of record rows and as many
    valid rows as ``repro``'s ``_explode``."""
    import jax.numpy as jnp

    from repro.core import naive as jnaive
    rng = np.random.default_rng(seed)
    sigma = int(rng.integers(1, 9))
    toks, _ = lanes_input(rng, sigma, min(vocab, 1 << 20))
    got, valid = naive._explode(torch.as_tensor(toks), sigma, vocab)
    want, jvalid = jnaive._explode(jnp.asarray(toks), sigma, vocab)
    got, want = got.numpy(), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  want[np.lexsort(want.T[::-1])])
    assert int(valid.sum()) == int(np.asarray(jvalid).sum())
    np.testing.assert_array_equal(got[:, -1], valid.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_membership_hashes_and_member_match_repro(seed):
    """The APRIORI dictionary: the sorted hash set of the valid grams, and
    membership of present, absent and sentinel queries."""
    import jax.numpy as jnp

    from repro.core import common as jcommon
    rng = np.random.default_rng(seed)
    n_l = int(rng.integers(1, 4))
    lanes = rng.integers(0, 1 << 32, (int(rng.integers(1, 200)), n_l),
                         dtype=np.uint64)
    lanes[rng.random(lanes.shape[0]) < 0.3] = lanes[0]         # duplicates
    valid = rng.random(lanes.shape[0]) < 0.6
    got = common.membership_hashes(torch.as_tensor(lanes.astype(np.int64)),
                                   torch.as_tensor(valid))
    want = jcommon.membership_hashes(jnp.asarray(lanes.astype(np.uint32)),
                                     jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    queries = np.concatenate([got.numpy()[rng.integers(0, got.shape[0], 50)],
                              rng.integers(0, 1 << 32, 50), [0xFFFFFFFF, 0]])
    np.testing.assert_array_equal(
        common.member(got, torch.as_tensor(queries)).numpy(),
        np.asarray(jcommon.member(want, jnp.asarray(queries.astype(np.uint32)))))


def sorted_records(rng, sigma, vocab, with_positions):
    """Seeded k-gram records of every length, sorted on their lanes (numpy,
    stable), as the sort phase hands them to the reducer."""
    toks, n_l = lanes_input(rng, sigma, vocab)
    tt = torch.as_tensor(toks)
    rec = torch.cat([common.kgram_records(tt, k, sigma, vocab, with_positions=True)[0]
                     for k in range(1, sigma + 1)]).numpy()
    rec[:, n_l + 1] = np.arange(rec.shape[0])          # one position a row
    rec = rec[np.lexsort(rec[:, :n_l].T[::-1])]
    return rec if with_positions else rec[:, :n_l + 1]


@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_reduce_exact_matches_repro(seed, with_positions):
    """The whole-gram reducer on the same sorted records: terms, flags,
    counts and (with positions) the run totals at every position; and
    ``count_exact_grams`` (sort + reduce) gives the same grams."""
    import jax.numpy as jnp

    from repro.core import common as jcommon
    from repro.pipeline import stages as jstages
    rng = np.random.default_rng(seed)
    sigma = int(rng.integers(1, 7))
    vocab = int(rng.choice([4, 30, 20_000]))
    rec = sorted_records(rng, sigma, vocab, with_positions)
    got = stages.reduce_exact(torch.as_tensor(rec), sigma=sigma, vocab_size=vocab,
                              with_positions=with_positions)
    want = jstages.reduce_exact(jnp.asarray(rec.astype(np.uint32)), sigma=sigma,
                                vocab_size=vocab, with_positions=with_positions)
    assert len(got) == len(want) == 3 + with_positions
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    shuffled = rec[rng.permutation(rec.shape[0])]
    got = common.count_exact_grams(torch.as_tensor(shuffled), sigma=sigma,
                                   vocab_size=vocab)
    want = jcommon.count_exact_grams(jnp.asarray(shuffled.astype(np.uint32)),
                                     sigma=sigma, vocab_size=vocab)
    from repro.core.stats import NGramStats as JStats
    from repro_torch.core import NGramStats
    assert NGramStats.from_dense(*(x.numpy() for x in got[:3]), 1).to_dict() == \
        JStats.from_dense(*(np.asarray(x) for x in want[:3]), 1).to_dict()


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_cuda_emit_matches_cpu(cuda_device, seed):
    """The whole-gram emits on the card (``suffix_pack`` lanes and the
    prefix masks) equal the same calls on the CPU: ``kgram_records`` for
    every k, with a weight mask and positions, and NAIVE's explode."""
    rng = np.random.default_rng(seed)
    sigma = int(rng.integers(1, 9))
    vocab = int(rng.choice([3, 20_000, 1 << 30]))
    toks, _ = lanes_input(rng, sigma, min(vocab, 1 << 20))
    mask = rng.random(toks.shape[0]) < 0.7
    on_card, on_cpu = torch.as_tensor(toks, device=cuda_device), torch.as_tensor(toks)
    for k in range(1, sigma + 1):
        got = common.kgram_records(on_card, k, sigma, vocab,
                                   weight_mask=torch.as_tensor(mask, device=cuda_device),
                                   with_positions=True)
        want = common.kgram_records(on_cpu, k, sigma, vocab,
                                    weight_mask=torch.as_tensor(mask), with_positions=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    for g, w in zip(naive._explode(on_card, sigma, vocab),
                    naive._explode(on_cpu, sigma, vocab)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_cuda_reduce_exact_matches_cpu(cuda_device, seed, with_positions):
    rng = np.random.default_rng(seed)
    sigma = int(rng.integers(1, 7))
    vocab = int(rng.choice([4, 30, 20_000]))
    rec = torch.as_tensor(sorted_records(rng, sigma, vocab, with_positions))
    got = stages.reduce_exact(rec.to(cuda_device), sigma=sigma, vocab_size=vocab,
                              with_positions=with_positions)
    want = stages.reduce_exact(rec, sigma=sigma, vocab_size=vocab,
                               with_positions=with_positions)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
