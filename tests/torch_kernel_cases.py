"""The case registries of the port's kernel tests (``test_torch_kernels*.py``):
not collected itself, imported by each of those files.

``KERNEL_CASES`` mirrors ``tests/test_kernels.py::KERNEL_CASES`` for the
eight kernels of the port.  Each case draws inputs with numpy from a
seed and returns two calls: the port's op on a device (a CPU tensor runs its
plain version), and ``repro``'s reference and Pallas kernel (interpret mode).
``EDGE_CASES`` holds the kernels' edge cases, each a port call and
``repro``'s reference.  Every output is an integer, so every comparison is
exact.  JAX is imported on first use only: the ``cuda`` tests run on a GPU
host that has no JAX.  The ``check_*`` functions are the bodies of the
tests that run each case, which the test files split between them by kernel
(:data:`EDGE_FILES`) so that a parallel run spreads them over its workers.
"""
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the lcp_boundary edge matrices)

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)


def _jax():
    """(jax.numpy, repro.kernels.ref, repro.kernels.ops), imported on demand."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jnp, jref, jops


def lex_sorted(rng, n, l, vmax=6):
    t = rng.integers(0, vmax, (n, l)).astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


def _case_lcp_boundary(rng, scale):
    n = int(rng.integers(1, 40 * scale + 2))
    l = int(rng.integers(1, 100))
    terms = lex_sorted(rng, n, l, vmax=int(rng.integers(2, 9))).astype(np.int32)
    block = int(rng.choice([32, 64, 512]))
    return (lambda dev: ops.lcp_boundary(torch.as_tensor(terms, device=dev)),
            lambda jnp, jref, jops: (
                jref.lcp_boundary_ref(jnp.asarray(terms)),
                jops.lcp_boundary(jnp.asarray(terms), block_rows=block)))


def _case_suffix_pack(rng, scale):
    """The lanes alone, or (half the draws) whole bucketed records: lanes |
    weight | meta, ``repro``'s ``make_records(bucket_ids=)`` layout."""
    n = int(rng.integers(1, 120 * scale + 2))
    sigma = int(rng.integers(1, 65))
    vocab = int(rng.choice([1, 3, 300, 20_000, 70_000, 1 << 30]))
    toks = rng.integers(0, min(vocab, 1 << 20) + 1, n).astype(np.int32)
    block = int(rng.choice([b for b in (32, 256, 1024) if b >= sigma]))
    meta = (rng.integers(0, 2**32, n).astype(np.uint32) if rng.random() < 0.5
            else None)

    def port(dev):
        t = torch.as_tensor(toks, device=dev)
        if meta is None:
            return ops.suffix_pack(t, sigma=sigma, vocab_size=vocab)
        from repro_torch.mapreduce import pack
        out = torch.empty((n, pack.n_lanes(sigma, vocab) + 2), dtype=torch.int64,
                          device=dev)
        return ops.suffix_pack(t, sigma=sigma, vocab_size=vocab, out=out,
                               meta=torch.as_tensor(meta.view(np.int32), device=dev))

    def records(jnp, lanes):
        if meta is None:
            return lanes
        return jnp.concatenate([lanes, jnp.asarray(toks != 0, jnp.uint32)[:, None],
                                jnp.asarray(meta)[:, None]], axis=1)

    return (port,
            lambda jnp, jref, jops: (
                records(jnp, jref.suffix_pack_ref(jnp.asarray(toks), sigma=sigma,
                                                  vocab_size=vocab)),
                records(jnp, jops.suffix_pack(jnp.asarray(toks), sigma=sigma,
                                              vocab_size=vocab, block=block))))


def _case_hash_partition(rng, scale):
    n = int(rng.integers(1, 200 * scale + 2))
    parts = int(rng.choice([2, 8, 16, 64, 512]))
    keys = rng.integers(0, 2**32, n).astype(np.uint32)     # bit 31 set too
    valid = rng.random(n) < 0.8
    block = int(rng.choice([64, 128, 512]))
    return (lambda dev: ops.hash_partition(
                torch.as_tensor(keys.astype(np.int64), device=dev),
                torch.as_tensor(valid, device=dev), n_parts=parts),
            lambda jnp, jref, jops: (
                jref.hash_partition_ref(jnp.asarray(keys), jnp.asarray(valid),
                                        parts),
                jops.hash_partition(jnp.asarray(keys), jnp.asarray(valid),
                                    n_parts=parts, block=block)))


def _case_bsearch(rng, scale):
    r = int(rng.integers(1, 200 * scale + 2))
    n_l = int(rng.integers(1, 4))
    q = int(rng.integers(1, 100 * scale + 2))
    # small values collide often; a high base puts bit 31 in every lane
    base = int(rng.choice([0, 2**31 + 5]))
    lanes = (base + lex_sorted(rng, r, n_l, vmax=50)).astype(np.uint32)
    queries = (base + rng.integers(0, 55, (q, n_l))).astype(np.uint32)
    lo = rng.integers(0, r + 1, q).astype(np.int32)          # lo == hi == r too
    hi = (lo + rng.integers(0, r, q)).clip(0, r).astype(np.int32)
    upper = bool(rng.integers(0, 2))
    block = int(rng.choice([64, 128, 1024]))

    def repro_calls(jnp, jref, jops):
        jargs = (jnp.asarray(lanes), jnp.asarray(queries), jnp.asarray(lo),
                 jnp.asarray(hi))
        return (jref.bsearch_ref(*jargs, upper=upper),
                jops.bsearch(*jargs, upper=upper, block=block))

    return (lambda dev: ops.bsearch(
                torch.as_tensor(lanes.astype(np.int64), device=dev),
                torch.as_tensor(queries.astype(np.int64), device=dev),
                torch.as_tensor(lo, device=dev), torch.as_tensor(hi, device=dev),
                upper=upper),
            repro_calls)


def _case_hash_combine(rng, scale):
    """Duplicate-heavy keys so slots collide both equal and unequal, weights
    up to 2**32 - 1 so the sums wrap, ragged tails (pad rows).  The port reads
    keys and weight through strided views of one record matrix, as
    ``stages.combine_hash`` passes them."""
    n = int(rng.integers(1, 300 * scale + 2))
    n_keys = int(rng.integers(1, 6))
    vmax = int(rng.choice([2, 5, 50, 2**32]))
    keys = rng.integers(0, vmax, (n, n_keys)).astype(np.uint32)
    weights = rng.choice([0, 1, 3, 2**31 + 7, 2**32 - 1], n).astype(np.uint32)
    block = int(rng.choice([32, 64, 256]))
    records = np.concatenate([keys, weights[:, None]], axis=1).astype(np.int64)
    return (lambda dev: (lambda r: ops.hash_combine(r[:, :n_keys], r[:, n_keys],
                                                    block=block))(
                torch.as_tensor(records, device=dev)),
            lambda jnp, jref, jops: (
                jref.hash_combine_ref(jnp.asarray(keys), jnp.asarray(weights),
                                      block=block),
                jops and jops.hash_combine(jnp.asarray(keys), jnp.asarray(weights),
                                           block=block)))


def _case_merge_path(rng, scale):
    """Sorted runs with duplicates within and across runs (the A-first tie
    rule), empty and singleton runs, lanes with bit 31 set."""
    n_l = int(rng.integers(1, 4))
    vmax = int(rng.choice([3, 20, 2**32]))
    m = int(rng.integers(0, 150 * scale + 2))
    n = int(rng.integers(0, 150 * scale + 2))
    a = lex_sorted(rng, m, n_l, vmax=vmax).astype(np.uint32)
    b = lex_sorted(rng, n, n_l, vmax=vmax).astype(np.uint32)
    if m and n and rng.integers(0, 2):      # force cross-run duplicates
        take = rng.integers(0, m, min(n, 8))
        b[:len(take)] = a[take]
        b = b[np.lexsort(b.T[::-1])]
    av = rng.integers(0, 2**32, m).astype(np.uint32)
    bv = rng.integers(0, 2**32, n).astype(np.uint32)
    block = int(rng.choice([64, 256, 1024]))

    def port(dev):
        t = [torch.as_tensor(x.astype(np.int64), device=dev) for x in (a, b, av, bv)]
        return ops.merge_path(*t)

    def repro_calls(jnp, jref, jops):
        args = [jnp.asarray(x) for x in (a, b, av, bv)]
        return (jref.merge_path_ref(*args),
                jops and jops.merge_path(*args, block=block))

    return port, repro_calls


def _front_coded_case(rng, scale):
    """Fuzzed compressed streams -- not only what ``compress_index`` writes --
    so the clamped fetches and a nonzero lcp at a block head are exercised.
    Bases stay below 2**24, so bit positions never wrap."""
    sigma = int(rng.choice([1, 3, 5, 8, 15]))
    term_bits = int(rng.integers(3, 17))
    lcp_width = 4 if sigma <= 14 else 8
    block_size = int(rng.choice([4, 8, 16]))
    nb = int(rng.integers(1, 20 * scale + 2))
    size = nb * block_size
    q = int(rng.integers(1, 80 * scale + 2))
    streams = (rng.integers(0, 2**32, -(-size * lcp_width // 32)).astype(np.uint32),
               rng.integers(0, 2**32, int(rng.integers(1, 200))).astype(np.uint32),
               np.sort(rng.integers(0, 2**24, nb + 1)).astype(np.uint32))
    sec = np.sort(rng.integers(0, size + 1, sigma + 1)).astype(np.int32)
    blk = rng.integers(0, nb, q).astype(np.int32)
    blk[0] = nb - 1
    kw = dict(term_bits=term_bits, lcp_width=lcp_width, block_size=block_size,
              len_off=int(rng.integers(0, 2)))
    return sigma, streams, sec, blk, kw


def _jit(fn, **kw):
    """``repro``'s reference as one compiled program: op-by-op dispatch of
    the block decoders' references takes seconds a call."""
    import functools

    import jax
    return jax.jit(functools.partial(fn, **kw))


def _port_streams(dev, streams, *rest):
    return [torch.as_tensor(w.view(np.int32), device=dev) for w in streams] + \
        [torch.as_tensor(x, device=dev) for x in rest]


def _case_block_expand(rng, scale):
    sigma, streams, sec, blk, kw = _front_coded_case(rng, scale)

    def repro_calls(jnp, jref, jops):
        args = [jnp.asarray(x) for x in (*streams, sec, blk)]
        return (_jit(jref.block_expand_ref, **kw)(*args),
                jops and jops.block_expand(*args, **kw, sigma=sigma, bblock=64))

    return (lambda dev: ops.block_expand(*_port_streams(dev, streams, sec, blk), **kw),
            repro_calls)


def _case_block_decode(rng, scale):
    sigma, streams, sec, blk, kw = _front_coded_case(rng, scale)
    qt = rng.integers(0, 1 << kw["term_bits"], (blk.shape[0], sigma)).astype(np.int32)
    ql = rng.integers(0, sigma + 2, blk.shape[0]).astype(np.int32)

    def repro_calls(jnp, jref, jops):
        args = [jnp.asarray(x) for x in (*streams, sec, blk, qt, ql)]
        return (_jit(jref.block_decode_ref, **kw)(*args),
                jops and jops.block_decode(*args, **kw, qblock=64))

    return (lambda dev: ops.block_decode(*_port_streams(dev, streams, sec, blk, qt, ql),
                                         **kw),
            repro_calls)


KERNEL_CASES = {
    "lcp_boundary": _case_lcp_boundary,
    "suffix_pack": _case_suffix_pack,
    "hash_partition": _case_hash_partition,
    "bsearch": _case_bsearch,
    "hash_combine": _case_hash_combine,
    "merge_path": _case_merge_path,
    "block_expand": _case_block_expand,
    "block_decode": _case_block_decode,
}


# Pallas kernels whose interpret mode takes seconds a call: the larger sweeps
# hold the port against repro's reference only (``jops`` is None there)
INTERPRET_SLOW = {"hash_combine", "merge_path", "block_expand", "block_decode"}


def _draw(name, sweep):
    # crc32, not hash(): string hashing is salted per process, and the sweep
    # must draw the same cases in every run to be debuggable
    rng = np.random.default_rng(zlib.crc32(f"torch/{name}/{sweep}".encode()))
    return KERNEL_CASES[name](rng, [1, 1, 4, 16][sweep])


def _assert_equal(got, want):
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


# --------------------------------------------------------------------------
# Edge cases of the redesigned suffix_pack and bsearch kernels: the tile
# edges of suffix_pack (T = 1024 positions for n_lanes <= 4; more lanes take
# the generic instance), sigma past 64, its records output, and bsearch's
# lane-count instances, bracket widths around the 2**2 rows of a round trip,
# truncated steps, both index dtypes and both bounds.  Each case: (port call
# on a device, repro's reference), compared exactly on the CPU and, on a
# card, kernel against plain version.
# --------------------------------------------------------------------------

def _suffix_pack_edge(toks, sigma, vocab, records, meta=None):
    """Without ``records`` a fresh [N, n_lanes] lane matrix; with it the
    map's [N, n_lanes + 1] records (lanes | weight), written into a matrix
    that held -1; with ``meta`` (uint32 [N]) too, [N, n_lanes + 2] records
    (lanes | weight | meta)."""
    from repro_torch.mapreduce import pack
    n_l = pack.n_lanes(sigma, vocab)
    cols = n_l + 1 + (meta is not None)

    def port(dev):
        t = torch.as_tensor(toks, device=dev)
        if not records:
            return ops.suffix_pack(t, sigma=sigma, vocab_size=vocab)
        rec = torch.full((len(toks), cols), -1, dtype=torch.int64, device=dev)
        m = None if meta is None else torch.as_tensor(meta.view(np.int32), device=dev)
        assert ops.suffix_pack(t, sigma=sigma, vocab_size=vocab, out=rec,
                               meta=m).data_ptr() == rec.data_ptr()
        return rec

    def want(jnp, jref):
        lanes = np.asarray(jref.suffix_pack_ref(jnp.asarray(toks), sigma=sigma,
                                                vocab_size=vocab)).astype(np.int64)
        if records:
            lanes = np.concatenate([lanes, (toks != 0)[:, None]], axis=1)
        if meta is not None:
            lanes = np.concatenate([lanes, meta.astype(np.int64)[:, None]], axis=1)
        return lanes

    return port, want


#: (sigma, vocab) past the first port's tile limits: 128 terms in 4 lanes of
#: 32 one-bit terms (the widest halo of the tiled instances); 65 and 300
#: lanes of one term (the generic instance)
WIDE_SIGMAS = ((128, 1), (65, 1 << 30), (300, 1 << 30))


def _suffix_pack_edges():
    rng = np.random.default_rng(13)
    cases = {}
    for n in (1, 3, 63, 64, 65, 1023, 1024, 1025, 2049):
        for sigma, vocab in ((5, 20_000), (40, 1 << 30)):      # tiled; generic
            toks = rng.integers(1, 300, n).astype(np.int32)
            edge = 1024 if sigma == 5 else 64
            toks[max(0, min(n, edge) - 3):edge + 2] = 0       # PAD run across a tile edge
            cases[f"suffix_pack-n{n}-sigma{sigma}"] = _suffix_pack_edge(
                toks, sigma, vocab, n > 3 and n % 2 == 1)
    toks = rng.integers(0, 5, 3000).astype(np.int32)
    for sigma, vocab in ((1, 20_000), (1, 1 << 30), (64, 1 << 30), (64, 3), *WIDE_SIGMAS):
        cases[f"suffix_pack-sigma{sigma}-vocab{vocab}"] = _suffix_pack_edge(
            toks, sigma, vocab, False)
    big = rng.integers(0, 2**20, 5000).astype(np.int32)
    for out in ("new", "records"):
        for sigma, vocab in ((5, 20_000), (8, 300), (2, 3), (64, 1 << 30), *WIDE_SIGMAS):
            cases[f"suffix_pack-out-{out}-sigma{sigma}-vocab{vocab}"] = \
                _suffix_pack_edge(big % (vocab + 1), sigma, vocab, out == "records")
    # bucketed records (lanes | weight | meta) for every tiled lane count,
    # the widest tile (NL = 4: 1024 x 6 columns, dynamic shared memory) with
    # the widest halo, and the generic instance (sigma 40, 20 lanes; the
    # sigma-split reference job), at the tile edges; meta words >= 2**31
    for n_l, sigma, vocab in ((1, 2, 20_000), (2, 3, 20_000), (3, 5, 20_000),
                              (4, 8, 20_000), (4, 128, 1), (20, 40, 20_000)):
        for n in (1, 1023, 1025, 3001):
            toks = rng.integers(0, min(vocab, 300) + 1, n).astype(np.int32)
            meta = rng.integers(0, 2**32, n).astype(np.uint32)
            meta[:2] = np.asarray([2**32 - 1, 2**31], np.uint32)[:n]
            cases[f"suffix_pack-meta-nl{n_l}-n{n}-sigma{sigma}-vocab{vocab}"] = \
                _suffix_pack_edge(toks, sigma, vocab, True, meta)
    return cases


#: where the searched lanes sit in a wider matrix: (columns before, columns
#: after).  With an even row stride the kernel reads lane pairs with 16-byte
#: loads, starting at lane 0 (no column before) or lane 1 (one before).
LAYOUTS = {"dense": (0, 0), "offset": (1, 0), "leading": (0, 1), "middle": (1, 1)}


def _bsearch_edge(lanes, layout, queries, lo, hi, index_dtype, upper, steps):
    """``lanes`` [R, L] sorted uint32 values, searched as a view of a wider
    matrix (``LAYOUTS``) whose other columns hold junk."""
    before, after = LAYOUTS[layout]

    def port(dev):
        junk = np.full((lanes.shape[0], 1), 2**32 - 1, np.int64)
        full = np.concatenate([junk] * before + [lanes.astype(np.int64)] + [junk] * after,
                              axis=1)
        view = torch.as_tensor(full, device=dev)[:, before:before + lanes.shape[1]]
        return ops.bsearch(view, torch.as_tensor(queries.astype(np.int64), device=dev),
                           torch.as_tensor(lo.astype(index_dtype), device=dev),
                           torch.as_tensor(hi.astype(index_dtype), device=dev),
                           upper=upper, steps=steps)

    def want(jnp, jref):
        return np.asarray(jref.bsearch_ref(
            jnp.asarray(lanes), jnp.asarray(queries), jnp.asarray(lo),
            jnp.asarray(hi), upper=upper, steps=steps))

    return port, want


def _bsearch_edges():
    rng = np.random.default_rng(14)
    cases = {}
    r, q = 300, 600
    widths = np.array([0, 1, 3, 4, 7, 8, 15, 16, r])     # 0, 1, 2**d - 1, 2**d, R
    for n_l in (1, 2, 3, 4, 6):
        # few distinct values: long runs of equal rows; every lane >= 2**31
        lanes = (2**31 + lex_sorted(rng, r, n_l, vmax=3)).astype(np.uint32)
        queries = (2**31 + rng.integers(0, 4, (q, n_l))).astype(np.uint32)
        width = widths[rng.integers(0, len(widths), q)]
        lo = rng.integers(0, r + 1 - width).astype(np.int32)
        hi = (lo + width).astype(np.int32)
        for k, layout in enumerate(LAYOUTS):
            index_dtype = (np.int32, np.int64)[k % 2]
            for upper in (False, True):
                for steps in (None, 1, 3):                  # full, and too few
                    full = steps is None
                    cases[f"bsearch-nl{n_l}-{layout}-{'upper' if upper else 'lower'}-"
                          f"{np.dtype(index_dtype).name}-steps{'full' if full else steps}"
                          ] = _bsearch_edge(
                        lanes, layout, queries, lo, hi, index_dtype, upper,
                        ref.search_steps(r) if full else steps)
    return cases


#: the block decoders' grid: every group width of the warp-group decode, full
#: (1, 4, 8, 16 and 32 lanes) and part-used (2 and 3 rows in a group of 4, 17
#: in a group of 32), and the generic walk (33)
BLOCK_SIZES = (1, 2, 3, 4, 8, 16, 17, 32, 33)
#: sigma 1, 5 and 15 (8-bit lcps, and more columns than a group of 4 or 8
#: lanes); a few cases at sigma 40 take the instance that holds no row in
#: registers
BLOCK_SIGMAS = (1, 5, 15)


def _block_streams(rng, sigma, block_size):
    """Fuzzed front-coded streams (as ``_front_coded_case`` draws them) of a
    few blocks, and 40 requested ids: arbitrary, repeated, and the last
    block."""
    term_bits = int(rng.choice([3, 7, 15, 16]))
    lcp_width = 4 if sigma <= 14 else 8
    nb = int(rng.integers(2, 12))
    size = nb * block_size
    streams = (rng.integers(0, 2**32, -(-size * lcp_width // 32)).astype(np.uint32),
               rng.integers(0, 2**32, int(rng.integers(1, 200))).astype(np.uint32),
               np.sort(rng.integers(0, 2**24, nb + 1)).astype(np.uint32))
    sec = np.sort(rng.integers(0, size + 1, sigma + 1)).astype(np.int32)
    blk = rng.integers(0, nb, 40).astype(np.int32)
    blk[:3] = nb - 1
    blk[3:8] = blk[8]
    return streams, sec, blk, dict(term_bits=term_bits, lcp_width=lcp_width,
                                   block_size=block_size)


def _block_expand_edge(streams, sec, blk, kw, vocab):
    """With ``vocab``, the rows packed into a row-strided view of a matrix
    that held -1, one row short of B * block_size: the matrix is returned, so
    the columns around the view and the rows past it must stay -1.  Without,
    the int32 term rows."""
    sigma = sec.shape[0] - 1

    if vocab is None:
        def port(dev):
            return ops.block_expand(*_port_streams(dev, streams, sec, blk), **kw)

        def want(jnp, jref):
            args = [jnp.asarray(x) for x in (*streams, sec, blk)]
            return np.asarray(_jit(jref.block_expand_ref, **kw)(*args))
        return port, want

    from repro_torch.mapreduce import pack
    n_l = pack.n_lanes(sigma, vocab)
    n = blk.shape[0] * kw["block_size"] - 1

    def port(dev):
        full = torch.full((n + 3, n_l + 2), -1, dtype=torch.int64, device=dev)
        view = full[:n, 1:1 + n_l]
        assert ops.block_expand(*_port_streams(dev, streams, sec, blk), **kw, out=view,
                                vocab_size=vocab) is view
        return full

    def want(jnp, jref):
        from repro.mapreduce import pack as jpack
        args = [jnp.asarray(x) for x in (*streams, sec, blk)]
        terms = _jit(jref.block_expand_ref, **kw)(*args).reshape(-1, sigma)
        full = np.full((n + 3, n_l + 2), -1, np.int64)
        full[:n, 1:1 + n_l] = np.asarray(jpack.pack_terms(terms, vocab_size=vocab))[:n]
        return full

    return port, want


def _block_decode_edge(rng, streams, sec, blk, kw):
    """Queries on each block: half of them a row of the block itself (its
    terms and length key, so cnt_eq counts), half drawn at random."""
    sigma = sec.shape[0] - 1
    bs = kw["block_size"]
    rows = ref.block_expand_ref(*_port_streams("cpu", streams, sec, blk),
                                **kw).numpy()                   # [Q, bs, sigma]
    pick = rng.integers(0, bs, blk.shape[0])
    own = rows[np.arange(blk.shape[0]), pick]
    own_len = (blk.astype(np.int64) * bs + pick)[:, None] >= sec[None, :]
    qt = rng.integers(0, 1 << kw["term_bits"], (blk.shape[0], sigma)).astype(np.int32)
    ql = rng.integers(0, sigma + 2, blk.shape[0]).astype(np.int32)
    mine = rng.random(blk.shape[0]) < 0.5
    qt[mine], ql[mine] = own[mine], own_len.sum(axis=1)[mine]

    def port(dev):
        return torch.stack(ops.block_decode(
            *_port_streams(dev, streams, sec, blk, qt, ql), **kw))

    def want(jnp, jref):
        args = [jnp.asarray(x) for x in (*streams, sec, blk, qt, ql)]
        return np.stack([np.asarray(x) for x in
                         _jit(jref.block_decode_ref, **kw)(*args)])

    return port, want


def _block_edges():
    rng = np.random.default_rng(15)
    cases = {}
    for bs in BLOCK_SIZES:
        for sigma in BLOCK_SIGMAS:
            for off in (0, 1):
                streams, sec, blk, kw = _block_streams(rng, sigma, bs)
                kw["len_off"] = off
                vocab = (1 << kw["term_bits"]) - 1          # bits_for_vocab == term_bits
                tag = f"bs{bs}-sigma{sigma}-off{off}"
                cases[f"block_expand-out-{tag}"] = _block_expand_edge(
                    streams, sec, blk, kw, vocab)
                if sigma == 5:
                    cases[f"block_expand-terms-{tag}"] = _block_expand_edge(
                        streams, sec, blk, kw, None)
                cases[f"block_decode-{tag}"] = _block_decode_edge(
                    rng, streams, sec, blk, kw)
    for bs in (3, 16):                  # sigma past 32: terms fetched a column at a time
        streams, sec, blk, kw = _block_streams(rng, 40, bs)
        kw["len_off"] = 1
        tag = f"bs{bs}-sigma40-off1"
        cases[f"block_expand-out-{tag}"] = _block_expand_edge(
            streams, sec, blk, kw, (1 << kw["term_bits"]) - 1)
        cases[f"block_decode-{tag}"] = _block_decode_edge(rng, streams, sec, blk, kw)
    return cases


# --------------------------------------------------------------------------
# Edge cases of the redesigned hash_combine and merge_path kernels.
# hash_combine: the records instance (keys and weight the columns of one
# contiguous [N, K + 1] matrix, K = 1-4, combined in place through ``out=``
# the weight column, tiles of 1,024 rows) and the generic instance (K = 5, an
# 8-byte offset base, separate tensors); N off the tile and the block, every
# block size, all keys equal or all distinct, weights that wrap.  merge_path:
# runs inside one tile of 512 output rows and across many, ties that
# straddle tile edges, K = 1-5 (tiled) and 6 (generic), lanes >= 2**31.
# --------------------------------------------------------------------------

#: where the combined keys and weights lie: "records" one [N, K + 1] matrix
#: combined in place; "offset" the same at an 8-byte offset (unaligned for
#: 16-byte loads); "separate" two tensors and a fresh output
COMBINE_LAYOUTS = ("records", "offset", "separate")


def _hash_combine_edge(keys, weights, block, layout):
    """``keys`` [N, K] and ``weights`` [N] uint32 values.  In the matrix
    layouts the whole matrix is returned, so the keys and row order must come
    back untouched beside the combined weight column."""
    k = keys.shape[1]
    rec = np.concatenate([keys, weights[:, None]], axis=1).astype(np.int64)

    def port(dev):
        if layout == "separate":
            return ops.hash_combine(torch.as_tensor(keys.astype(np.int64), device=dev),
                                    torch.as_tensor(weights.astype(np.int64), device=dev),
                                    block=block)
        off = int(layout == "offset")
        flat = torch.zeros(rec.size + 2, dtype=torch.int64, device=dev)
        r = flat[off:off + rec.size].view(rec.shape)
        r.copy_(torch.as_tensor(rec))
        w = r[:, k]
        assert ops.hash_combine(r[:, :k], w, block=block, out=w) is w
        return r

    def want(jnp, jref):
        got = np.asarray(jref.hash_combine_ref(jnp.asarray(keys), jnp.asarray(weights),
                                               block=block)).astype(np.int64)
        return got if layout == "separate" else np.concatenate([rec[:, :k], got[:, None]],
                                                               axis=1)

    return port, want


def _hash_combine_edges():
    rng = np.random.default_rng(17)
    cases = {}

    def keys_of(kind, n, k):
        if kind == "equal":
            return np.full((n, k), 2**31 + 5, np.uint32)
        if kind == "distinct":          # row i's lanes spell i: no two rows equal
            return ((np.arange(n)[:, None] + 7 * np.arange(k)[None, :]) % 2**32
                    ).astype(np.uint32) | np.uint32(2**31) * (np.arange(k) == 0)
        return rng.integers(0, 3, (n, k)).astype(np.uint32) + np.uint32(2**31)

    grid = [(k, block) for k in (1, 2, 3, 4, 5) for block in (32, 64, 256, 1024)]
    sizes = (1, 255, 1023, 1025, 3001)
    for i, (k, block) in enumerate(grid):
        n = sizes[i % len(sizes)] if block < 1024 or i % 2 else 2049
        kind = ("dup", "equal", "distinct")[i % 3]
        weights = rng.choice([0, 1, 3, 2**31 + 7, 2**32 - 1], n).astype(np.uint32)
        cases[f"hash_combine-records-k{k}-block{block}-n{n}-{kind}"] = _hash_combine_edge(
            keys_of(kind, n, k), weights, block, "records")
    for k, block, n in ((3, 256, 3001), (2, 1024, 1025), (5, 64, 999)):
        weights = rng.choice([0, 1, 2**32 - 1], n).astype(np.uint32)
        for layout in COMBINE_LAYOUTS[1:]:
            cases[f"hash_combine-{layout}-k{k}-block{block}-n{n}-dup"] = _hash_combine_edge(
                keys_of("dup", n, k), weights, block, layout)
    return cases


def _merge_path_edge(a, b, av, bv):
    """Sorted uint32 runs and their values; the merged keys and values come
    back as one [M + N, K + 1] matrix."""
    def port(dev):
        t = [torch.as_tensor(x.astype(np.int64), device=dev) for x in (a, b, av, bv)]
        keys, vals = ops.merge_path(*t)
        return torch.cat([keys, vals[:, None]], dim=1)

    def want(jnp, jref):
        keys, vals = jref.merge_path_ref(*[jnp.asarray(x) for x in (a, b, av, bv)])
        return np.concatenate([np.asarray(keys).astype(np.int64),
                               np.asarray(vals).astype(np.int64)[:, None]], axis=1)

    return port, want


def _tied_run(n, run, k, shift=0):
    """n sorted rows whose keys change every ``run`` rows (from row
    ``shift``): long runs of equal keys, equal across runs built alike."""
    ids = (np.arange(n) + shift) // run
    # ids in base 3, most significant lane first (lane 0 unbounded)
    lanes = [ids // 3 ** (k - 1 - c) % (3 if c else n + 1) for c in range(k)]
    return (np.uint32(2**31) + np.stack(lanes, axis=1)).astype(np.uint32)


def _merge_path_edges():
    rng = np.random.default_rng(18)
    cases = {}

    def vals(n):
        return rng.integers(0, 2**32, n).astype(np.uint32)

    for m, n, k, vmax in ((1, 1, 4, 3), (1, 900, 4, 5), (900, 1, 3, 5), (3, 5, 1, 2),
                          (300, 700, 2, 4), (3000, 2500, 4, 2**32), (5000, 1, 5, 3),
                          (1, 3000, 1, 9), (2000, 2100, 6, 3), (700, 4, 6, 2)):
        a = lex_sorted(rng, m, k, vmax=vmax).astype(np.uint32)
        b = lex_sorted(rng, n, k, vmax=vmax).astype(np.uint32)
        if vmax < 2**32:
            a, b = a + np.uint32(2**31), b + np.uint32(2**31)
        if m > 3 and n > 3:                       # sentinel tails on both runs
            a[-2:], b[-3:] = 2**32 - 1, 2**32 - 1
        cases[f"merge_path-k{k}-m{m}-n{n}"] = _merge_path_edge(a, b, vals(m), vals(n))
    # ties across A and B at every multiple of 256 and 1,024 rows, straddling
    # the tiles of 512 output rows, at every lane count
    for k in (1, 2, 3, 4, 5, 6):
        for run, (m, n), shift in ((256, (4096, 3000), 0), (1024, (3500, 4100), 100)):
            a, b = _tied_run(m, run, k), _tied_run(n, run, k, shift)
            cases[f"merge_path-ties{run}-k{k}-m{m}-n{n}"] = _merge_path_edge(a, b, vals(m), vals(n))
    return cases


def _lcp_boundary_edge(terms, offset=0, pallas=True):
    """``terms`` [N, L] int32 as a contiguous view ``offset`` words into its
    storage (not 16-byte aligned for offset 1-3); lcp and flags come back as
    one [N, L + 1] matrix.  ``repro``'s Pallas kernel (interpret mode) must
    equal its reference unless ``pallas`` is False."""
    n, length = terms.shape

    def port(dev):
        flat = torch.zeros(n * length + offset, dtype=torch.int32, device=dev)
        x = flat[offset:].view(n, length)
        x.copy_(torch.as_tensor(terms))
        lcp, flags = ops.lcp_boundary(x)
        return torch.cat([lcp[:, None], flags.to(torch.int32)], dim=1)

    def want(jnp, jref):
        def joined(out):
            return np.concatenate([np.asarray(out[0])[:, None],
                                   np.asarray(out[1]).astype(np.int32)], axis=1)
        got = joined(jref.lcp_boundary_ref(jnp.asarray(terms)))
        if pallas:
            np.testing.assert_array_equal(joined(_jax()[2].lcp_boundary(jnp.asarray(terms))),
                                          got)
        return got

    return port, want


def _lcp_boundary_edges():
    """``chip_smoke.py``'s edge matrices: every case is compared with
    ``repro``'s reference and Pallas kernel, except the INT_MIN row 0 (its
    kernel compares row 0 with an INT_MIN sentinel row; its reference, and
    the port, give row 0 lcp 0), compared with the reference only."""
    return {f"lcp_boundary-{name}": _lcp_boundary_edge(terms, offset,
                                                        pallas=name != "intmin-row0")
            for name, terms, offset in chip_smoke.lcp_edge_matrices(np.random.default_rng(20))}


EDGE_CASES = {**_suffix_pack_edges(), **_bsearch_edges(), **_block_edges(),
              **_hash_combine_edges(), **_merge_path_edges(), **_lcp_boundary_edges()}


def _tiny_streams(dev):
    """Two blocks of 4 rows, sigma 3, as int32 word tensors on ``dev``."""
    rng = np.random.default_rng(16)
    streams, sec, _, kw = _block_streams(rng, 3, 4)
    nb = streams[2].shape[0] - 1
    return _port_streams(dev, streams, sec), dict(kw, len_off=0), nb


def _empty_ids(dev):
    """Both block kernels on an empty id list: empty outputs, out untouched."""
    streams, kw, _ = _tiny_streams(dev)
    blk = torch.zeros((0,), dtype=torch.int32, device=dev)
    terms = ops.block_expand(*streams, blk, **kw)
    assert terms.shape == (0, 4, 3) and terms.dtype == torch.int32
    out = torch.full((0, 1), -1, dtype=torch.int64, device=dev)
    assert ops.block_expand(*streams, blk, **kw, out=out, vocab_size=100) is out
    lt, eq = ops.block_decode(*streams, blk, torch.zeros((0, 3), dtype=torch.int32,
                                                         device=dev),
                              torch.zeros((0,), dtype=torch.int32, device=dev), **kw)
    assert lt.shape == eq.shape == (0,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


# ------------------------------------------------------------ the test bodies
def check_sweep(name, sweep):
    port_call, repro_calls = _draw(name, sweep)
    before = dict(ops.launches)
    got = port_call("cpu")
    assert dict(ops.launches) == before      # a CPU tensor launches no kernel
    jnp, jref, jops = _jax()
    with_kernel = sweep == 0 or name not in INTERPRET_SLOW
    want_ref, want_kernel = repro_calls(jnp, jref, jops if with_kernel else None)
    _assert_equal(got, want_ref)
    if with_kernel:
        _assert_equal(got, want_kernel)


def check_cuda_sweep(cuda_device, name, sweep):
    port_call, _ = _draw(name, sweep)
    before = ops.launches[name]
    got = port_call(cuda_device)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    _assert_equal(got, port_call("cpu"))


def check_edge(case):
    port, want = EDGE_CASES[case]
    jnp, jref, _ = _jax()
    np.testing.assert_array_equal(port("cpu").numpy().astype(np.int64),
                                  want(jnp, jref).astype(np.int64))


def check_cuda_edge(cuda_device, case):
    port, _ = EDGE_CASES[case]
    name = case.split("-")[0]
    before = ops.launches[name]
    got = port(cuda_device)
    torch.cuda.synchronize()
    assert ops.launches[name] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), port("cpu").numpy())


# test file (tests/test_torch_kernels_edge_<key>.py) -> the kernels whose
# edge cases it runs
EDGE_FILES = {"expand": ("block_expand",), "decode": ("block_decode",),
              "lcp": ("lcp_boundary",), "combine": ("hash_combine", "merge_path"),
              "search": ("bsearch",), "pack": ("suffix_pack",)}


def edge_names(kernels) -> list[str]:
    """The names of the edge cases of ``kernels``, sorted."""
    return sorted(c for c in EDGE_CASES if c.split("-")[0] in kernels)

