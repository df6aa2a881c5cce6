"""The port's MapReduce primitives against ``repro.mapreduce`` on CPU.

Inputs come from numpy with a seed and go through both packages; every
output is an integer, so every comparison is exact.  Vocabularies range from
2 to 2**30 and lanes carry bit 31, the cases where the port's int64 lane
representation could part from uint32.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax.numpy as jnp
from repro.core import suffix_sigma as j_suffix
from repro.mapreduce import pack as jpack
from repro.mapreduce import segment as jseg
from repro.mapreduce import shuffle as jshuffle
from repro.mapreduce import sort as jsort
from repro.pipeline import stages as jstages
from repro_torch.core import suffix_sigma
from repro_torch.mapreduce import pack, segment, shuffle, sort
from repro_torch.pipeline import stages

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

VOCABS = [1, 2, 3, 255, 300, 20_000, 65_535, 70_000, 2**24, 2**30]


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("vocab", VOCABS)
def test_pack_unpack_lead_masks(vocab):
    rng = np.random.default_rng(vocab)
    sigma = int(rng.integers(1, 12))
    terms = rng.integers(0, min(vocab, 2**30) + 1, (300, sigma)).astype(np.int32)
    assert pack.n_lanes(sigma, vocab) == jpack.n_lanes(sigma, vocab)
    assert pack.record_bytes(sigma, vocab, 1) == jpack.record_bytes(sigma, vocab, 1)
    lanes = pack.pack_terms(_t(terms), vocab_size=vocab)
    _eq(lanes, jpack.pack_terms(jnp.asarray(terms), vocab_size=vocab))
    np.testing.assert_array_equal(pack.pack_terms_np(terms, vocab_size=vocab),
                                  jpack.pack_terms_np(terms, vocab_size=vocab))
    np.testing.assert_array_equal(pack.prefix_lane_masks(sigma, vocab),
                                  jpack.prefix_lane_masks(sigma, vocab))
    _eq(pack.unpack_terms(lanes, vocab_size=vocab, sigma=sigma), terms)
    # arbitrary lanes, bit 31 set in about half of them
    raw = rng.integers(0, 2**32, (300, lanes.shape[1])).astype(np.uint32)
    _eq(pack.unpack_terms(_t(raw), vocab_size=vocab, sigma=sigma),
        jpack.unpack_terms(jnp.asarray(raw), vocab_size=vocab, sigma=sigma))
    _eq(pack.lead_term(_t(raw[:, 0]), vocab_size=vocab),
        jpack.lead_term(jnp.asarray(raw[:, 0]), vocab_size=vocab))


def test_pack_wraps_out_of_range_ids_like_uint32():
    """Ids past the vocab and negative ids wrap exactly as uint32 packing does."""
    rng = np.random.default_rng(1)
    terms = rng.integers(-2**31, 2**31, (200, 5)).astype(np.int32)
    for vocab in (3, 300, 70_000):
        _eq(pack.pack_terms(_t(terms.astype(np.int64)), vocab_size=vocab),
            jpack.pack_terms(jnp.asarray(terms), vocab_size=vocab))


def test_hash_fold_partition():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**32, 5000).astype(np.uint32)
    keys[:4] = [0, 1, 2**31, 2**32 - 1]
    _eq(shuffle.hash_u32(_t(keys)), jshuffle.hash_u32(jnp.asarray(keys)))
    lanes = rng.integers(0, 2**32, (5000, 3)).astype(np.uint32)
    _eq(shuffle.fold_hash(_t(lanes)), jshuffle.fold_hash(jnp.asarray(lanes)))
    valid = rng.random(5000) < 0.7
    for n_parts in (1, 7, 64, 1000):
        _eq(shuffle.partition_ids(_t(keys), torch.as_tensor(valid), n_parts),
            jshuffle.partition_ids(jnp.asarray(keys), jnp.asarray(valid), n_parts))
    for kind in ("gram", "lead"):
        _eq(shuffle.record_key(_t(lanes), kind=kind, vocab_size=20_000),
            jshuffle.record_key(jnp.asarray(lanes), kind=kind, vocab_size=20_000))


@pytest.mark.parametrize("n_keys", [1, 2, 3, 4, 5])
def test_sort_records_and_payload(n_keys):
    rng = np.random.default_rng(n_keys)
    n = 3000
    vmax = int(rng.choice([4, 2**32]))
    rec = rng.integers(0, vmax, (n, n_keys + 2)).astype(np.uint32)
    rec[: n // 4, :n_keys] |= np.uint32(2**31)
    got = sort.sort_records(_t(rec), n_keys=n_keys).numpy()
    want = np.asarray(jsort.sort_records(jnp.asarray(rec), n_keys=n_keys))
    # repro sorts unstably: keys agree row for row, the rows as a multiset
    np.testing.assert_array_equal(got[:, :n_keys], want[:, :n_keys])
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  want[np.lexsort(want.T[::-1])].astype(np.int64))
    keys_s, (pay,) = sort.sort_with_payload(_t(rec[:, :n_keys]),
                                            [_t(rec[:, -1])])
    np.testing.assert_array_equal(keys_s.numpy(), want[:, :n_keys])
    np.testing.assert_array_equal(np.sort(pay.numpy()), np.sort(rec[:, -1]))


@pytest.mark.parametrize("seed", range(3))
def test_segment_run_counts(seed):
    rng = np.random.default_rng(seed)
    n, l = int(rng.integers(1, 400)), int(rng.integers(1, 9))
    t = rng.integers(0, 4, (n, l)).astype(np.int32)
    t = t * np.cumprod(t != 0, axis=1)           # PAD-terminated suffixes
    t = t[np.lexsort(t.T[::-1])]
    w = rng.integers(0, 3, n).astype(np.int32)
    lcp = segment.lcp_lengths(torch.as_tensor(t))
    _eq(lcp, jseg.lcp_lengths(jnp.asarray(t)))
    flags = segment.boundary_flags(torch.as_tensor(t), lcp)
    jflags = jseg.boundary_flags(jnp.asarray(t), jnp.asarray(lcp.numpy()))
    _eq(flags, jflags)
    _eq(segment.run_counts(flags, torch.as_tensor(t != 0), torch.as_tensor(w),
                           max_segments=n),
        jseg.run_counts(jflags, jnp.asarray(t != 0), jnp.asarray(w),
                        max_segments=n))


@pytest.mark.parametrize("vocab,sigma", [(5, 3), (39, 4), (300, 7), (70_000, 5)])
def test_map_combine_reduce_stages(vocab, sigma):
    """suffix windows -> map emit -> combine -> reduce, stage by stage."""
    rng = np.random.default_rng(vocab)
    toks = rng.integers(0, vocab + 1, 600).astype(np.int32)
    toks[rng.random(600) < 0.1] = 0
    win, valid = suffix_sigma.suffix_windows(torch.as_tensor(toks), sigma)
    jwin, jvalid = j_suffix.suffix_windows(jnp.asarray(toks), sigma)
    _eq(win, jwin)
    _eq(valid, jvalid)
    rec, _ = suffix_sigma.make_records(torch.as_tensor(toks), sigma=sigma,
                                       vocab_size=vocab)
    jrec, _ = j_suffix.make_records(jnp.asarray(toks), sigma=sigma,
                                    vocab_size=vocab)
    _eq(rec, jrec)
    n_l = pack.n_lanes(sigma, vocab)
    comb = stages.combine(rec, n_l, route="sort")
    _eq(comb, jstages.combine(jrec, n_l, False, route="sort"))
    srt = stages.sort_stage(comb, n_keys=n_l)
    for use_kernels in (False, True):
        want = jstages.reduce_suffix(jnp.asarray(srt.numpy().astype(np.uint32)),
                                     sigma=sigma, vocab_size=vocab,
                                     use_kernels=use_kernels)
        for g, w in zip(stages.reduce_suffix(srt, sigma=sigma, vocab_size=vocab),
                        want):
            _eq(g, w)
