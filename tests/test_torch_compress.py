"""The port's compressed index against ``repro.index.compress`` on CPU.

Bit streams, Elias-Fano sequences and every array of ``compress_index`` must
equal ``repro``'s (as uint32 words), and so must ``nbytes_at_rest``; the
decoded views and segments must round-trip; compressed ``lookup`` and
``continuations`` must answer as ``repro`` does, both on the port's own build
and on a ``repro`` index carried across by ``compressed_index_from_arrays``.
Every output is an integer, so every comparison is exact.  ``repro`` runs
through its jnp path.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import jax.numpy as jnp
import repro.core as jcore
import repro.index as jindex
from repro.core.stats import NGramConfig as JConfig
from repro.core.stats import NGramStats as JStats
from repro.index import compress as jcompress
from repro.kernels import bitpack as jbitpack
from repro_torch.core import NGramConfig, NGramStats, oracle, run_job
from repro_torch.index import (build_index, compress_index,
                               compressed_index_from_arrays, continuations,
                               decode_segment, lookup, segment_from_stats)
from repro_torch.index import compress as tcompress
from repro_torch.kernels import bitpack
from repro_torch.kernels import ops, ref
from repro_torch.mapreduce import pack
from test_compress import CORPUS_DRAWS, make_corpus, query_batches

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)


def repro_arrays(jc) -> tuple[dict, dict]:
    """(arrays, meta) of a ``repro`` compressed index, as numpy."""
    arrays = {name: np.asarray(getattr(jc, name)) for name in tcompress.STREAMS}
    for name in tcompress.EF_FIELDS:
        ef = getattr(jc, name)
        arrays[name] = dict(low=np.asarray(ef.low), high=np.asarray(ef.high),
                            word_rank=np.asarray(ef.word_rank), n=ef.n,
                            low_bits=ef.low_bits, universe=ef.universe)
    for name in ("sec_cache", "cumsum_cache", "fan_cache", "cont_fan_cache"):
        arrays[name] = np.asarray(getattr(jc, name))
    return arrays, {name: getattr(jc, name) for name in tcompress.META}


def stream_arrays(c) -> dict:
    """Every at-rest array of a port compressed index as uint32 numpy."""
    out = {name: bitpack.words_u32(getattr(c, name)) for name in tcompress.STREAMS}
    for name in tcompress.EF_FIELDS:
        for part in ("low", "high", "word_rank"):
            out[f"{name}.{part}"] = bitpack.words_u32(getattr(getattr(c, name), part))
    return out


def assert_same_compressed(c, jc):
    """Every at-rest array as uint32 words, the caches as values, the meta."""
    got = stream_arrays(c)
    for name in tcompress.STREAMS:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jc, name)),
                                      err_msg=name)
    for name in tcompress.EF_FIELDS:
        ef = getattr(jc, name)
        for part in ("low", "high", "word_rank"):
            np.testing.assert_array_equal(got[f"{name}.{part}"],
                                          np.asarray(getattr(ef, part)),
                                          err_msg=f"{name}.{part}")
        assert (getattr(c, name).n, getattr(c, name).low_bits,
                getattr(c, name).universe) == (ef.n, ef.low_bits, ef.universe)
    for name in ("sec_cache", "cumsum_cache", "fan_cache", "cont_fan_cache"):
        np.testing.assert_array_equal(getattr(c, name).numpy().astype(np.int64),
                                      np.asarray(getattr(jc, name)).astype(np.int64),
                                      err_msg=name)
    for name in tcompress.META:
        assert getattr(c, name) == getattr(jc, name), name
    assert c.nbytes_at_rest == jc.nbytes_at_rest


def assert_same_answers(c, jc, exp, seed):
    """lookup / continuations of the port's compressed index == repro's."""
    rng = np.random.default_rng(seed)
    for g, ln, want in query_batches(exp, jc, rng):
        got = lookup(c, g, ln).numpy()
        np.testing.assert_array_equal(got, np.asarray(jindex.lookup(jc, g, ln)))
        np.testing.assert_array_equal(got, want)
    pool = sorted({t[:-1] for t in exp if len(t) >= 2})
    picks = [pool[i] for i in rng.choice(len(pool), min(30, len(pool)))] if pool else []
    prefixes = [(), ()] + picks + [(c.vocab_size + 2,)] + picks[:5]
    pg = np.zeros((len(prefixes), c.sigma), np.int32)
    pl = np.zeros(len(prefixes), np.int32)
    for i, p in enumerate(prefixes):
        pg[i, :len(p)] = p
        pl[i] = len(p)
    for a, b in zip(continuations(c, pg, pl, k=8),
                    jindex.continuations(jc, pg, pl, k=8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("width", [0, 1, 4, 7, 8, 17, 31, 32])
def test_bit_streams_match_repro(width):
    rng = np.random.default_rng(width)
    n = 300
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64) if width else np.zeros(n)
    words = bitpack.words_u32(bitpack.pack_words(torch.as_tensor(vals.astype(np.int64)),
                                                 width))
    np.testing.assert_array_equal(words, jbitpack.pack_bits(vals, width))
    # positions in range, past the end and negative: clamped fetches agree
    pos = np.concatenate([np.arange(n), rng.integers(-50, 2 * n + 50, 200)])
    got = bitpack.extract_bits(bitpack.as_words(words, "cpu"),
                               torch.as_tensor(pos), width).numpy()
    want = np.asarray(jbitpack.extract_bits(jnp.asarray(words), jnp.asarray(pos),
                                            width))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(got[:n], vals.astype(np.int64))


def test_elias_fano_adversarial_sequences():
    rng = np.random.default_rng(0)
    seqs = [
        np.zeros(5, np.int64),
        np.full(7, 1000, np.int64),
        np.arange(100, dtype=np.int64),
        np.sort(rng.integers(0, 2**31 - 1, 1000)),
        np.repeat(rng.integers(0, 50, 20).cumsum(), rng.integers(1, 5, 20)),
    ]
    for s in seqs:
        for universe in (None, int(s.max()) * 2 + 10):
            ef = tcompress.EliasFano.encode(s, universe=universe, device="cpu")
            jef = jcompress.EliasFano.encode(s, universe=universe)
            for part in ("low", "high", "word_rank"):
                np.testing.assert_array_equal(bitpack.words_u32(getattr(ef, part)),
                                              np.asarray(getattr(jef, part)))
            i = torch.arange(ef.n)
            np.testing.assert_array_equal(ef.select(i).numpy(), s)
            np.testing.assert_array_equal(ef.decode_all().numpy(), s)
            np.testing.assert_array_equal(ef.select_many(i[: max(1, ef.n // 8)]).numpy(),
                                          s[: max(1, ef.n // 8)])
            np.testing.assert_array_equal(ef.select_many(i).numpy(), s)
            assert ef.nbytes == jef.nbytes
    with pytest.raises(ValueError):
        tcompress.EliasFano.encode(np.array([3, 2, 1]), device="cpu")
    with pytest.raises(ValueError):
        tcompress.EliasFano.encode(np.array([], np.int64), device="cpu")


@pytest.mark.parametrize("vocab,dist,sigma,tau,block,seed", CORPUS_DRAWS)
def test_compressed_index_matches_repro(vocab, dist, sigma, tau, block, seed):
    toks = make_corpus(5000, vocab, dist, seed)
    stats = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab),
                    device="cpu")
    exp = oracle.ngram_counts(toks, sigma, tau)
    jidx = jindex.build_index(jcore.run_job(
        toks, JConfig(sigma=sigma, tau=tau, vocab_size=vocab)), vocab_size=vocab)
    jc = jcompress.compress_index(jidx, block_size=block)
    c = compress_index(build_index(stats, vocab_size=vocab, device="cpu"),
                       block_size=block, device="cpu")
    assert_same_compressed(c, jc)
    for view in ("point", "cont"):
        np.testing.assert_array_equal(tcompress.decode_view(c, view),
                                      jcompress.decode_view(jc, view))
    assert_same_answers(c, jc, exp, seed)
    carried = compressed_index_from_arrays(*repro_arrays(jc), device="cpu")
    assert_same_compressed(carried, jc)
    assert_same_answers(carried, jc, exp, seed + 1)


def test_decode_segment_chunk_sweep(monkeypatch):
    """Chunk-size invariant, unpadded, equal to the sorted segment, and the
    decoded working set never exceeds one chunk."""
    vocab = 20
    toks = make_corpus(200, vocab, "zipf", 9)
    stats = run_job(toks, NGramConfig(sigma=3, tau=1, vocab_size=vocab), device="cpu")
    seg = segment_from_stats(stats, vocab_size=vocab, device="cpu")
    r = seg.n_rows
    c = compress_index(build_index(stats, vocab_size=vocab, device="cpu"),
                       block_size=4, device="cpu")
    jc = jcompress.compress_index(jindex.build_index(jcore.run_job(
        toks, JConfig(sigma=3, tau=1, vocab_size=vocab)), vocab_size=vocab))
    for chunk in (1, 3, 64, 10**9):
        monkeypatch.setitem(tcompress._DECODE_WATERMARK, "rows", 0)
        got = decode_segment(c, chunk_rows=chunk)
        assert got.n_rows == r == int(got.keys.shape[0])
        np.testing.assert_array_equal(got.keys.numpy(), seg.keys[:r].numpy())
        np.testing.assert_array_equal(got.counts.numpy(), seg.counts[:r].numpy())
        want = jcompress.decode_segment(jc, chunk_rows=chunk)
        np.testing.assert_array_equal(got.keys.numpy(),
                                      np.asarray(want.keys).astype(np.int64))
        assert tcompress._DECODE_WATERMARK["rows"] <= max(4, min(chunk, 10**4))
    padded = c.to_segment()
    np.testing.assert_array_equal(padded.keys.numpy(), seg.keys.numpy())
    np.testing.assert_array_equal(padded.counts.numpy(), seg.counts.numpy())


@pytest.mark.parametrize("sigma", [1, 5, 15])
@pytest.mark.parametrize("block_size", [1, 2, 3, 4, 8, 16, 17, 32, 33])
def test_block_expand_out_equals_repro_decode_segment(block_size, sigma):
    """Every block of a real compressed index through the plain
    ``block_expand(out=)`` into the key columns of a row-strided matrix: the
    lanes equal ``pack_terms`` of the decoded terms and ``repro``'s
    ``decode_segment``; the length column and the capacity rows past the
    real ones are left as they were."""
    vocab = 300
    toks = make_corpus(1500, vocab, "zipf", sigma)
    stats = run_job(toks, NGramConfig(sigma=sigma, tau=1, vocab_size=vocab), device="cpu")
    r = len(stats)
    pad = -(-(r + 1) // (128 * block_size)) * 128 * block_size   # a multiple of block_size
    c = compress_index(build_index(stats, vocab_size=vocab, pad_to=pad, device="cpu"),
                       block_size=block_size, device="cpu")
    jc = jcompress.compress_index(jindex.build_index(
        JStats(stats.grams, stats.lengths, stats.counts), vocab_size=vocab, pad_to=pad),
        block_size=block_size)
    assert c.n_rows == r < c.n_blocks * block_size
    keys = torch.full((r, 1 + c.n_lanes), -1, dtype=torch.int64)
    ids = torch.arange(c.n_blocks, dtype=torch.int32)
    args = (c.lcps, c.payload, c.block_base, c.sec_cache, ids)
    kw = dict(term_bits=c.term_bits, lcp_width=c.lcp_width, block_size=block_size,
              len_off=0)
    assert ops.block_expand(*args, **kw, out=keys[:, 1:], vocab_size=vocab) \
        .data_ptr() == keys[:, 1:].data_ptr()
    assert bool((keys[:, 0] == -1).all())
    packed = pack.pack_terms(ref.block_expand_ref(*args, **kw).reshape(-1, sigma),
                             vocab_size=vocab)
    np.testing.assert_array_equal(keys[:, 1:].numpy(), packed[:r].numpy())
    want = jcompress.decode_segment(jc)
    np.testing.assert_array_equal(keys[:, 1:].numpy(),
                                  np.asarray(want.keys)[:, 1:].astype(np.int64))


def test_decode_segment_default_chunk_matches_repro(monkeypatch):
    """At the port's default chunk a table of more rows than ``repro``'s
    4,096-row chunk decodes in one ``block_expand`` call, and equals
    ``repro``'s ``decode_segment`` (which takes several)."""
    vocab = 300
    toks = make_corpus(6000, vocab, "zipf", 12)
    stats = run_job(toks, NGramConfig(sigma=4, tau=1, vocab_size=vocab), device="cpu")
    c = compress_index(build_index(stats, vocab_size=vocab, device="cpu"), device="cpu")
    jc = jcompress.compress_index(jindex.build_index(
        JStats(stats.grams, stats.lengths, stats.counts), vocab_size=vocab))
    assert c.n_rows > jcompress._DECODE_CHUNK_ROWS
    calls = []
    expand = tcompress.kops.block_expand
    monkeypatch.setattr(tcompress.kops, "block_expand",
                        lambda *a, **k: calls.append(1) or expand(*a, **k))
    got = decode_segment(c)
    assert len(calls) == 1
    want = jcompress.decode_segment(jc)
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys).astype(np.int64))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts).astype(np.int64))


def test_empty_tiny_and_full_width_counts():
    cases = [
        (np.zeros((0, 3), np.int32), np.zeros(0, np.int32), np.zeros(0, np.int64)),
        (np.array([[5, 0, 0]], np.int32), np.array([1], np.int32),
         np.array([7], np.int64)),
        # one cf >= 2**31 forces count_width 32
        (np.array([[5, 0, 0], [6, 0, 0]], np.int32), np.array([1, 1], np.int32),
         np.array([2**31 + 5, 7], np.int64)),
    ]
    for grams, lengths, counts in cases:
        c = compress_index(build_index(NGramStats(grams, lengths, counts),
                                       vocab_size=10, device="cpu"), device="cpu")
        jc = jcompress.compress_index(jindex.build_index(
            JStats(grams, lengths, counts), vocab_size=10))
        assert_same_compressed(c, jc)
        exp = NGramStats(grams, lengths, counts).to_dict()
        assert_same_answers(c, jc, exp, 0)
    assert c.count_width == 32
