"""The port's kernel plain versions against ``repro``'s references, and the
CUDA kernels against their plain versions on the card: the registries'
coverage, the ops' argument checks, in-place outputs and truncated searches.

The case registries and the test bodies live in ``torch_kernel_cases.py``;
the registries' cases run in ``test_torch_kernels_sweep.py`` (the four
sweeps of every kernel) and ``test_torch_kernels_edge_*.py`` (the edge
cases, a file for a kernel or two), so that a parallel run spreads them
over its workers.  ``test_registry_covers_ops`` fails if a wrapper in
``repro_torch.kernels.ops`` has no case, and
``test_edge_case_files_cover_every_case`` if an edge case runs in no file.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_kernel_cases import (BLOCK_SIGMAS, BLOCK_SIZES, COMBINE_LAYOUTS,  # noqa: F401
                                EDGE_CASES, EDGE_FILES, KERNEL_CASES, LAYOUTS, WIDE_SIGMAS,
                                _block_streams, _empty_ids, _jax, _port_streams,
                                _tiny_streams, chip_smoke, cuda_device, edge_names,
                                lex_sorted)


def test_registry_covers_ops():
    """Every public kernel wrapper in the port's ops.py has a registered case."""
    public = {n for n, f in vars(ops).items()
              if callable(f) and not n.startswith("_")
              and inspect.getmodule(f) is ops}
    assert public == set(KERNEL_CASES), public ^ set(KERNEL_CASES)


def test_bsearch_plain_against_bisect():
    """The search's plain version vs Python row-tuple bisection, lanes with
    bit 31 set."""
    import bisect
    rng = np.random.default_rng(5)
    r, n_l, q = 500, 3, 400
    lanes = 2**31 + lex_sorted(rng, r, n_l, vmax=30)
    queries = 2**31 + rng.integers(0, 33, (q, n_l))
    lo = rng.integers(0, r, q)
    hi = (lo + rng.integers(0, r, q)).clip(0, r)
    rows = [tuple(x) for x in lanes.tolist()]
    for upper in (False, True):
        got = ref.bsearch_ref(torch.as_tensor(lanes), torch.as_tensor(queries),
                              torch.as_tensor(lo), torch.as_tensor(hi),
                              upper=upper)
        side = bisect.bisect_right if upper else bisect.bisect_left
        expect = [side(rows, tuple(qr), lo=int(l), hi=int(h))
                  for qr, l, h in zip(queries.tolist(), lo, hi)]
        np.testing.assert_array_equal(got.numpy(), expect)


def test_edge_case_registry_covers_every_lane_count_and_tile_edge():
    names = "\n".join(EDGE_CASES)
    for n_l in (1, 2, 3, 4, 6):
        for layout in LAYOUTS:
            assert f"bsearch-nl{n_l}-{layout}-" in names
    for n in (1, 1023, 1024, 1025):
        assert f"suffix_pack-n{n}-sigma5" in names
    for n_l in (1, 2, 3, 4, 20):                  # bucketed records, tiled and generic
        for n in (1, 1023, 1025):
            assert f"suffix_pack-meta-nl{n_l}-n{n}-" in names


def test_edge_case_registry_covers_the_block_grid():
    for bs in BLOCK_SIZES:
        for sigma in BLOCK_SIGMAS:
            for off in (0, 1):
                for kind in ("block_expand-out", "block_decode"):
                    assert f"{kind}-bs{bs}-sigma{sigma}-off{off}" in EDGE_CASES


def test_edge_case_registry_covers_both_instances_of_the_stream_kernels():
    names = "\n".join(EDGE_CASES)
    for k in (1, 2, 3, 4, 5):
        for block in (32, 64, 256, 1024):
            assert f"hash_combine-records-k{k}-block{block}-" in names
    for layout in COMBINE_LAYOUTS:
        assert f"hash_combine-{layout}-" in names
    for k in (1, 2, 3, 4, 5, 6):
        for run in (256, 1024):
            assert f"merge_path-ties{run}-k{k}-" in names
    assert "merge_path-k4-m1-n1" in names


def test_edge_case_registry_covers_the_lcp_boundary_tiles():
    """Every row length at N = 1, T - 1, T, T + 1 and 3T + 2 for the block of
    T rows the kernel takes: its tile from L = 6, 256 rows of one thread each
    at L <= 5; rows too long for a tile; zeros, unaligned views and the
    INT_MIN row 0."""
    for length in chip_smoke.LCP_EDGE_LENGTHS:
        t = ops._lcp_tile_rows(length)
        if length < ops.LCP_MIN_TILED_LENGTH:
            assert t == 0 and chip_smoke.lcp_block_rows(length) == 256
        else:
            assert t >= 16 and t % 16 == 0 and chip_smoke.lcp_block_rows(length) == t
        t = chip_smoke.lcp_block_rows(length)
        for n in (1, t - 1, t, t + 1, 3 * t + 2):
            assert f"lcp_boundary-L{length}-n{n}" in EDGE_CASES
    assert ops.LCP_MIN_TILED_LENGTH in chip_smoke.LCP_EDGE_LENGTHS
    long_rows = ops.LCP_MAX_TILED_LENGTH + 1
    assert ops._lcp_tile_rows(long_rows) == 0
    assert f"lcp_boundary-L{long_rows}-n257" in EDGE_CASES
    for kind in ("zeros-", "-off1", "-off2", "-off3", "intmin"):
        assert any(c.startswith("lcp_boundary") and kind in c for c in EDGE_CASES), kind


def test_plain_hash_combine_in_place_equals_a_fresh_output():
    """out= the weight column: the combined weights land there, the keys and
    every other column stay, as the fresh output computes them."""
    rng = np.random.default_rng(19)
    rec = torch.as_tensor(np.concatenate([rng.integers(0, 4, (3001, 3)),
                                          rng.integers(0, 2**32, (3001, 1))], axis=1))
    fresh = ops.hash_combine(rec[:, :3], rec[:, 3], block=64)
    before = rec.clone()
    w = rec[:, 3]
    assert ops.hash_combine(rec[:, :3], w, block=64, out=w) is w
    assert torch.equal(rec[:, 3], fresh)
    assert torch.equal(rec[:, :3], before[:, :3])


def test_hash_combine_rejects_a_misplaced_out():
    """out is an int64 [N] vector on the keys' device that may be the weights
    themselves but shares no other memory with the inputs."""
    rec = torch.zeros((10, 4), dtype=torch.int64)
    keys, w = rec[:, :3], rec[:, 3]
    for bad in (rec[:, 2],                                   # a key column
                rec.view(-1)[1:11],                          # overlapping, not the weights
                torch.zeros(9, dtype=torch.int64),           # length
                torch.zeros(10, dtype=torch.int32),          # dtype
                torch.zeros((10, 1), dtype=torch.int64),     # 2-d
                torch.zeros(10, dtype=torch.int64, device="meta")):
        with pytest.raises((ValueError, TypeError)):
            ops.hash_combine(keys, w, out=bad)


def test_edge_case_files_cover_every_case():
    """Every edge case runs in exactly one ``test_torch_kernels_edge_*.py``."""
    names = [c for kernels in EDGE_FILES.values() for c in edge_names(kernels)]
    assert sorted(names) == sorted(EDGE_CASES)
    assert all(edge_names(kernels) for kernels in EDGE_FILES.values())


@pytest.mark.parametrize("sigma,vocab", [(5, 20_000), (1, 7), (9, 70_000), (64, 1 << 30),
                                         *WIDE_SIGMAS])
def test_plain_suffix_pack_writes_records_in_place(sigma, vocab):
    """The plain version writes the map's records into ``out``: ``repro``'s
    lanes, then the weight (1 for a real token, 0 for PAD)."""
    from repro_torch.mapreduce import pack
    jnp, jref, _ = _jax()
    toks = np.random.default_rng(sigma).integers(0, min(vocab, 999) + 1, 777).astype(np.int32)
    n_l = pack.n_lanes(sigma, vocab)
    records = torch.full((777, n_l + 1), 12345, dtype=torch.int64)
    assert ops.suffix_pack(torch.as_tensor(toks), sigma=sigma, vocab_size=vocab,
                           out=records) is records
    np.testing.assert_array_equal(
        records[:, :n_l].numpy(),
        np.asarray(jref.suffix_pack_ref(jnp.asarray(toks), sigma=sigma,
                                        vocab_size=vocab)).astype(np.int64))
    np.testing.assert_array_equal(records[:, n_l].numpy(), toks != 0)


def test_suffix_pack_rejects_a_misshapen_meta():
    """meta is an int32 [N] vector on the tokens' device, and comes with an
    out of n_lanes + 2 columns."""
    toks = torch.ones(10, dtype=torch.int32)              # sigma 3 -> 2 lanes
    meta = torch.zeros(10, dtype=torch.int32)
    for out, bad in ((None, meta),                                          # no out
                     (torch.empty((10, 3), dtype=torch.int64), meta),       # no meta column
                     (torch.empty((10, 4), dtype=torch.int64), meta[:9]),   # length
                     (torch.empty((10, 4), dtype=torch.int64), meta.long()),
                     (torch.empty((10, 4), dtype=torch.int64), meta[:, None])):
        with pytest.raises((ValueError, TypeError)):
            ops.suffix_pack(toks, sigma=3, vocab_size=20_000, out=out, meta=bad)


def test_suffix_pack_rejects_a_misshapen_out():
    toks = torch.ones(10, dtype=torch.int32)              # sigma 3 -> 2 lanes + weight
    for bad in (torch.empty((10, 2), dtype=torch.int64),
                torch.empty((10, 4), dtype=torch.int64),
                torch.empty((9, 3), dtype=torch.int64),
                torch.empty((10, 3), dtype=torch.int32),
                torch.empty((10, 4), dtype=torch.int64)[:, :3],
                torch.empty((10, 6), dtype=torch.int64)[:, ::2]):
        with pytest.raises((ValueError, TypeError)):
            ops.suffix_pack(toks, sigma=3, vocab_size=20_000, out=bad)


def test_block_expand_rejects_a_misshapen_or_misplaced_out():
    """out must be an int64 [n <= B * block_size, n_lanes] view with a
    contiguous last dimension, on the ids' device, and comes with vocab_size."""
    streams, kw, _ = _tiny_streams("cpu")
    blk = torch.zeros(2, dtype=torch.int32)                 # 8 rows; 3 terms of 7 bits
    vocab = 100                                             # 4 terms a lane: 1 lane
    good = torch.zeros((8, 1), dtype=torch.int64)
    assert ops.block_expand(*streams, blk, **kw, out=good, vocab_size=vocab) is good
    for bad, v in ((torch.zeros((9, 1), dtype=torch.int64), vocab),    # too many rows
                   (torch.zeros((8, 2), dtype=torch.int64), vocab),    # lanes
                   (torch.zeros((8, 1), dtype=torch.int32), vocab),    # dtype
                   (torch.zeros((8,), dtype=torch.int64), vocab),      # 1-d
                   (torch.zeros((1, 1), dtype=torch.int64).expand(8, 1), vocab),  # rows overlap
                   (torch.zeros((8, 6), dtype=torch.int64)[:, ::2], 1 << 30),     # strided lanes
                   (torch.zeros((8, 1), dtype=torch.int64, device="meta"), vocab)):
        with pytest.raises((ValueError, TypeError)):
            ops.block_expand(*streams, blk, **kw, out=bad, vocab_size=v)
    with pytest.raises(ValueError):
        ops.block_expand(*streams, blk, **kw, out=good)       # no vocab_size
    with pytest.raises(ValueError):
        ops.block_expand(*streams, blk, **kw, vocab_size=vocab)  # no out


def test_block_kernels_take_an_empty_id_list():
    _empty_ids("cpu")


@pytest.mark.parametrize("steps", [1, 2, 4, 7])
@pytest.mark.parametrize("upper", [False, True])
def test_plain_bsearch_truncated_steps_matches_repro(steps, upper):
    """With fewer steps than the brackets need, the port's plain search stops
    where ``repro``'s does."""
    jnp, jref, _ = _jax()
    rng = np.random.default_rng(steps)
    r, q, n_l = 1000, 500, 3
    lanes = (2**31 + lex_sorted(rng, r, n_l, vmax=9)).astype(np.uint32)
    queries = (2**31 + rng.integers(0, 10, (q, n_l))).astype(np.uint32)
    lo = rng.integers(0, r, q).astype(np.int32)
    hi = (lo + rng.integers(0, r, q)).clip(0, r).astype(np.int32)
    got = ref.bsearch_ref(torch.as_tensor(lanes.astype(np.int64)),
                          torch.as_tensor(queries.astype(np.int64)),
                          torch.as_tensor(lo), torch.as_tensor(hi),
                          upper=upper, steps=steps)
    want = jref.bsearch_ref(jnp.asarray(lanes), jnp.asarray(queries),
                            jnp.asarray(lo), jnp.asarray(hi), upper=upper, steps=steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = ref.bsearch_ref(torch.as_tensor(lanes.astype(np.int64)),
                           torch.as_tensor(queries.astype(np.int64)),
                           torch.as_tensor(lo), torch.as_tensor(hi), upper=upper)
    assert steps >= ref.search_steps(r) or not torch.equal(got, full)


@pytest.mark.cuda
def test_cuda_block_kernels_take_an_empty_id_list(cuda_device):
    before = dict(ops.launches)
    _empty_ids(cuda_device)
    torch.cuda.synchronize()
    assert dict(ops.launches) == before                  # nothing to launch


@pytest.mark.cuda
def test_cuda_block_expand_rejects_an_out_off_the_card(cuda_device):
    streams, kw, _ = _tiny_streams(cuda_device)
    blk = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ops.block_expand(*streams, blk, **kw, out=torch.zeros((8, 1), dtype=torch.int64),
                         vocab_size=100)
