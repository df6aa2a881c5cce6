"""The single job's host finish: the length-major materialize, the device
check ``stages.rows_ascending`` and the skip of ``canonical_stats``.

The check must say of a block exactly whether ``canonical_stats`` returns it
unchanged (nothing to reorder, no repeat to sum): on hand-made blocks, and
on random ones, where that is the definition.  ``materialize_canonical``
must keep the same cells as ``materialize``, only in another order.  A
traced job's ``stages.canonical`` span counts ``presorted``: 1 when the host
sort was skipped, and the output still equals ``repro``'s.  The module
imports no JAX at its top; the parity test imports it after
``pytest.importorskip``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import NGramConfig, NGramStats, run_job
from repro_torch.obs import trace
from repro_torch.pipeline import canonical_stats, stages
from repro_torch.pipeline.executor import materialize, materialize_canonical

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take cores from the
# other workers' tests.
torch.set_num_threads(1)


def block(rows, lengths, counts):
    """A hand-made job output, typed as ``materialize`` leaves one."""
    grams = np.asarray(rows, np.int32)
    return NGramStats(grams, np.asarray(lengths, np.int32),
                      np.asarray(counts, np.int64), {"jobs": 1})


def ascending(stats) -> bool:
    out = stages.rows_ascending(torch.from_numpy(stats.grams),
                                torch.from_numpy(stats.lengths))
    assert out.dtype == torch.bool and out.shape == ()
    return bool(out)


def same_stats(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
               for x, y in ((a.grams, b.grams), (a.lengths, b.lengths),
                            (a.counts, b.counts))) and a.counters == b.counters


CASES = {
    "strictly_ascending": (block([[1, 0, 0], [4, 0, 0], [1, 2, 0], [1, 3, 0],
                                  [2, 1, 0], [1, 2, 3]], [1, 1, 2, 2, 2, 3],
                                 [9, 5, 4, 3, 8, 2]), True),
    "one_repeated_row": (block([[1, 0, 0], [1, 2, 0], [1, 2, 0], [2, 1, 0]],
                               [1, 2, 2, 2], [3, 4, 5, 6]), False),
    "descending_pair_in_a_length": (block([[1, 0, 0], [2, 3, 0], [2, 1, 0]],
                                          [1, 2, 2], [3, 4, 5]), False),
    "length_drops": (block([[1, 0, 0], [1, 2, 0], [3, 0, 0]], [1, 2, 1],
                           [3, 4, 5]), False),
    "equal_terms_at_two_lengths": (block([[5, 0, 0], [5, 0, 0], [5, 0, 0]],
                                         [1, 2, 3], [7, 6, 5]), True),
    "empty": (block(np.zeros((0, 3)), [], []), True),
    "single_row": (block([[4, 2, 7]], [3], [11]), True),
    "series_counts": (block([[1, 0, 0], [2, 0, 0], [1, 1, 0]], [1, 1, 2],
                            [[1, 2], [0, 5], [3, 3]]), True),
    "series_counts_repeat": (block([[1, 0, 0], [1, 0, 0]], [1, 1],
                                   [[1, 2], [0, 5]]), False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_decides_each_hand_made_block(name):
    """The check's answer on each block, and what the skip would return
    (the rows as they are) equals ``canonical_stats`` array for array,
    dtypes included, exactly when the check passes."""
    stats, want = CASES[name]
    assert ascending(stats) is want
    assert same_stats(canonical_stats(stats), stats) is want


@pytest.mark.parametrize("seed", range(4))
def test_check_is_exact_on_random_blocks(seed):
    """Over small random blocks (short lengths, a vocabulary of three, so
    repeats, drops and swaps are common), and the same blocks put through
    ``canonical_stats`` first, the check holds exactly where
    ``canonical_stats`` is the identity."""
    rng = np.random.default_rng(seed)
    hits = {True: 0, False: 0}
    for _ in range(150):
        r, sigma = int(rng.integers(0, 6)), int(rng.integers(1, 4))
        lengths = rng.integers(1, sigma + 1, r)
        grams = rng.integers(1, 4, (r, sigma)) * (np.arange(sigma) < lengths[:, None])
        counts = rng.integers(1, 9, (r, 2) if seed % 2 else r)
        stats = block(grams, lengths, counts)
        for s in (stats, canonical_stats(stats)):
            ok = ascending(s)
            assert ok is same_stats(canonical_stats(s), s)
            hits[ok] += 1
    assert min(hits.values()) > 50


def dense_block(rng, n, sigma, n_buckets):
    terms = torch.from_numpy(rng.integers(0, 6, (n, sigma)).astype(np.int32))
    flags = torch.from_numpy(rng.random((n, sigma)) < 0.4)
    shape = (n, sigma, n_buckets) if n_buckets else (n, sigma)
    counts = torch.from_numpy(rng.integers(0, 4, shape).astype(np.int32))
    return terms, flags, counts


def row_multiset(stats):
    c = stats.counts if stats.counts.ndim == 2 else stats.counts[:, None]
    keys = np.concatenate([stats.lengths[:, None], stats.grams, c], axis=1)
    return keys[np.lexsort(keys.T[::-1])]


@pytest.mark.parametrize("n_buckets", [0, 3])
@pytest.mark.parametrize("seed", range(3))
def test_length_major_materialize_keeps_the_row_major_cells(seed, n_buckets):
    """On random dense reducer outputs (unsorted, with repeats), with and
    without [N, sigma, B] series counts: the same multiset of (length,
    gram, counts) rows, the same dtypes, lengths in non-decreasing order,
    row-major order within each length, and ``presorted`` equal to the
    check of the rows returned."""
    rng = np.random.default_rng(seed)
    for n, sigma, tau in ((0, 3, 1), (1, 1, 1), (257, 4, 2), (64, 5, 1)):
        dense = dense_block(rng, n, sigma, n_buckets)
        row_major = materialize(dense, tau)
        got, presorted = materialize_canonical(dense, tau)
        for a, b in ((got.grams, row_major.grams), (got.lengths, row_major.lengths),
                     (got.counts, row_major.counts)):
            assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(row_multiset(got), row_multiset(row_major))
        assert np.all(np.diff(got.lengths) >= 0)
        order = np.argsort(row_major.lengths, kind="stable")
        np.testing.assert_array_equal(got.grams, row_major.grams[order])
        np.testing.assert_array_equal(got.counts, row_major.counts[order])
        assert presorted is ascending(got)


def test_sorted_reducer_output_comes_out_presorted():
    """A sorted suffix block through ``reduce_suffix`` (every distinct
    prefix flagged once) materializes length-major to the rows that
    ``canonical_stats`` returns, and the check says so."""
    rng = np.random.default_rng(5)
    terms = rng.integers(1, 5, (300, 4)).astype(np.int32)
    terms[rng.random((300, 4)) < 0.1] = 0
    terms *= np.cumprod(terms != 0, axis=1).astype(np.int32)   # PAD ends a suffix
    terms = terms[np.lexsort(terms.T[::-1])]
    lanes = torch.from_numpy(terms.astype(np.int64))            # one term a lane
    rec = torch.cat([lanes, torch.ones((300, 1), dtype=torch.int64)], dim=1)
    dense = stages.reduce_suffix(rec, sigma=4, vocab_size=1 << 30)
    got, presorted = materialize_canonical(dense, 2)
    assert presorted and len(got) > 20
    assert same_stats(canonical_stats(got), got)


def traced_job(toks, cfg, **kw):
    tracer = trace.enable_tracing()
    try:
        out = run_job(toks, cfg, device="cpu", **kw)
    finally:
        trace.disable_tracing()
    spans = [e for e in tracer.events if e["name"] == "stages.canonical"]
    assert len(spans) == 1 and spans[0]["args"]["rows"] == len(out)
    return out, spans[0]["args"]["presorted"]


JOBS = {
    # one round, every distinct prefix flagged once in sorted order
    "suffix_sigma_sort": (dict(method="suffix_sigma", combine_route="sort"), False, 1),
    "suffix_sigma_hash": (dict(method="suffix_sigma", combine_route="hash"), False, 1),
    "suffix_sigma_buckets": (dict(method="suffix_sigma", n_buckets=3), True, 1),
    # one round too: see the test's docstring
    "naive": (dict(method="naive"), False, 1),
    # sigma rounds merged on the host: the host sort runs
    "apriori_scan": (dict(method="apriori_scan"), False, 0),
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_canonical_span_counts_presorted_and_output_is_repros(name):
    """``presorted`` of the job's ``stages.canonical`` span per method, the
    output in canonical order and equal to ``repro``'s ``run_job`` (grams,
    lengths, counts, dtypes and counters).

    NAIVE reads 1: it is one round, its exact reducer flags each distinct
    whole gram once, on the first row of its run in lane order, at its own
    length, and a gram's lanes hold PAD past its length, so a length's grams
    come out distinct and ascending as SUFFIX-sigma's prefixes do."""
    pytest.importorskip("jax")
    import repro.core as jcore
    from repro.core.stats import NGramConfig as JConfig
    from test_compress import make_corpus

    kw, series, want = JOBS[name]
    vocab = 40
    toks = make_corpus(3000, vocab, "zipf", 7)
    extra = {}
    if series:
        years = np.random.default_rng(7).integers(0, kw["n_buckets"], len(toks))
        extra = dict(bucket_ids=years.astype(np.int32))
    cfg = dict(sigma=4, tau=2, vocab_size=vocab, **kw)
    got, presorted = traced_job(toks, NGramConfig(**cfg), **extra)
    assert presorted == want
    assert len(got) > 100
    assert same_stats(canonical_stats(got), got)
    jextra = {k: v.astype(np.uint32) for k, v in extra.items()}
    ref = jcore.run_job(toks, JConfig(**cfg), **jextra)
    for a, b in ((got.grams, ref.grams), (got.lengths, ref.lengths),
                 (got.counts, ref.counts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.counters == ref.counters
