"""Plain PyTorch versions of the hand-written kernels (mirrors ``repro.kernels.ref``).

``kernels.ops`` runs these for CPU tensors; the CPU tests hold them against
``repro``'s references and Pallas kernels, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  Nothing on the main path calls them
for a CUDA tensor.
"""
from __future__ import annotations

import math

import torch

from repro_torch import U32
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import segment
from repro_torch.mapreduce.shuffle import fold_hash, hash_u32
from .bitpack import extract_bits


def search_steps(n_rows: int) -> int:
    """Fixed iteration count covering any [lo, hi) bracket within n_rows rows."""
    return max(1, math.ceil(math.log2(max(n_rows, 2)))) + 1


def suffix_windows(tokens: torch.Tensor, sigma: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """All sigma-truncated suffixes of a PAD-separated token stream.

    Returns (windows [N, sigma] int32 zeroed after the first PAD, valid [N]).
    """
    n = tokens.shape[0]
    padded = torch.cat([tokens, tokens.new_zeros(sigma)])
    idx = (torch.arange(n, device=tokens.device)[:, None]
           + torch.arange(sigma, device=tokens.device)[None, :])
    w = padded[idx]
    keep = torch.cumprod((w != 0).to(torch.int32), dim=1)
    return (w * keep).to(torch.int32), tokens != 0


def suffix_pack_ref(tokens: torch.Tensor, *, sigma: int, vocab_size: int,
                    out: torch.Tensor | None = None,
                    meta: torch.Tensor | None = None) -> torch.Tensor:
    """Packed sigma-truncated suffix lanes [N, n_lanes] int64 of a token stream.

    With ``out`` ([N, n_lanes + 1]) the map's records are written there:
    the lanes, then the weight, 1 for a real token and 0 for PAD; with
    ``meta`` ([N] int32) too, ``out`` is [N, n_lanes + 2] and its last
    column holds each meta word as a uint32 value.
    """
    windows, valid = suffix_windows(tokens, sigma)
    lanes = packing.pack_terms(windows, vocab_size=vocab_size)
    if out is None:
        return lanes
    n_l = lanes.shape[1]
    out[:, :n_l] = lanes
    out[:, n_l] = valid
    if meta is not None:
        out[:, n_l + 1] = meta.to(torch.int64) & U32
    return out


def hash_partition_ref(keys: torch.Tensor, valid: torch.Tensor, n_parts: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(partition ids [N] int32 with n_parts for invalid, histogram [n_parts] int32)."""
    p = (hash_u32(keys) % n_parts).to(torch.int32)
    p = torch.where(valid, p, n_parts)
    hist = torch.zeros(n_parts + 1, dtype=torch.int32, device=p.device).index_add_(
        0, p.long(), torch.ones_like(p))[:n_parts]
    return p, hist


def lcp_boundary_ref(sorted_terms: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lcp [N] int32, flags [N, L] bool) of a lexicographically sorted matrix."""
    lcp = segment.lcp_lengths(sorted_terms)
    return lcp, segment.boundary_flags(sorted_terms, lcp)


def bsearch_ref(lanes: torch.Tensor, queries: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, *, upper: bool = False,
                steps: int | None = None) -> torch.Tensor:
    """Batched lexicographic lower (or upper) bound [Q] int32 of packed query
    lanes [Q, L] in sorted lanes [R, L], each within its own [lo, hi).

    A fixed number of branchless halving steps, all queries in lockstep.
    """
    if steps is None:
        steps = search_steps(lanes.shape[0])
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    if lanes.shape[0] == 0:
        return lo.to(torch.int32)
    for _ in range(steps):
        mid = (lo + hi) // 2
        rows = lanes[mid.clamp(max=lanes.shape[0] - 1)]     # [Q, L]
        # lexicographic row < query, lane by lane (a scan along the short
        # lane axis of [Q, L] is slow on the card at Q in the hundreds of
        # millions)
        go_right = torch.zeros_like(lo, dtype=torch.bool)
        prefix_eq = torch.ones_like(go_right)
        for c in range(rows.shape[1]):
            go_right |= prefix_eq & (rows[:, c] < queries[:, c])
            prefix_eq &= rows[:, c] == queries[:, c]
        if upper:
            go_right |= prefix_eq
        open_ = lo < hi
        lo = torch.where(open_ & go_right, mid + 1, lo)
        hi = torch.where(open_ & ~go_right, mid, hi)
    return lo.to(torch.int32)


def hash_combine_ref(keys: torch.Tensor, weights: torch.Tensor, *,
                     block: int = 256, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Redistributed weights [N] int64 (uint32 values) of the block-local
    hash-slot combiner.

    Per ``block`` rows (the tail padded with zero-key, zero-weight rows),
    each row hashes its key lanes into one of ``2 * block`` slots; the
    smallest row index of a slot wins it (a scatter-min); rows whose key
    equals their winner's give it their weight, summed mod 2**32; slot losers
    keep theirs.  Row order never changes.  With ``out`` the result is
    computed whole, then copied there (``out`` may be ``weights`` itself).
    """
    n, n_keys = keys.shape
    nb = max(1, -(-n // block))
    n_pad = nb * block
    dev = keys.device
    k = torch.zeros((n_pad, n_keys), dtype=torch.int64, device=dev)
    k[:n] = keys & U32
    w = torch.zeros((n_pad,), dtype=torch.int64, device=dev)
    w[:n] = weights & U32
    n_slots = 2 * block
    rows = torch.arange(n_pad, device=dev)
    ids, blk = rows % block, rows // block
    gslot = blk * n_slots + fold_hash(k) % n_slots
    winner = torch.full((nb * n_slots,), block, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, gslot, ids, reduce="amin")
    rep = winner[gslot]
    rep_row = blk * block + rep
    match = (k[rep_row] == k).all(dim=1)
    contrib = torch.where(match, w, 0)
    totals = torch.zeros_like(w).index_add_(0, rep_row, contrib) & U32
    res = torch.where(rep == ids, totals, torch.where(match, 0, w))[:n]
    if out is None:
        return res
    out.copy_(res)
    return out


def merge_path_ref(a_keys: torch.Tensor, b_keys: torch.Tensor,
                   a_vals: torch.Tensor, b_vals: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys [M+N, K], vals [M+N]): stable two-way merge of sorted key rows,
    every A row before every equal B row.

    Rank and scatter, as ``repro``'s reference: an A row lands at its index
    plus the number of strictly smaller B rows, a B row at its index plus the
    number of A rows at most equal to it -- a different derivation from the
    kernel's diagonal search.
    """
    m, n = a_keys.shape[0], b_keys.shape[0]
    dev = a_keys.device
    zeros_m = torch.zeros((m,), dtype=torch.int32, device=dev)
    zeros_n = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos_a = torch.arange(m, device=dev) + bsearch_ref(
        b_keys, a_keys, zeros_m, zeros_m + n, upper=False).to(torch.int64)
    pos_b = torch.arange(n, device=dev) + bsearch_ref(
        a_keys, b_keys, zeros_n, zeros_n + m, upper=True).to(torch.int64)
    keys = a_keys.new_empty((m + n, a_keys.shape[1]))
    keys[pos_a] = a_keys
    keys[pos_b] = b_keys
    vals = a_vals.new_empty((m + n,))
    vals[pos_a] = a_vals
    vals[pos_b] = b_vals
    return keys, vals


def _front_coded_rows(lcps, payload, block_base, sec_starts, blk, *,
                      term_bits: int, lcp_width: int, block_size: int,
                      len_off: int):
    """Yield (row length [B], decoded row [B, sigma] int32) for each of the
    ``block_size`` rows of every requested block, in order.

    The front-coding chain, all blocks in lockstep: lane j of a row is the
    previous row's below its lcp, a payload term below its stored length, else
    0; block heads start from a zero row.  Stream reads go through
    ``extract_bits`` (uint32 positions, clamped word fetches).
    """
    sigma = sec_starts.shape[0] - 1
    dev = blk.device
    blk = blk.to(torch.int64)
    sec = sec_starts.to(torch.int64)
    j = torch.arange(sigma, device=dev)[None, :]
    off = block_base[blk].to(torch.int64)      # int32 view, as repro reads it
    prev = torch.zeros((blk.shape[0], sigma), dtype=torch.int64, device=dev)
    for r in range(block_size):
        g = blk * block_size + r
        lcp = extract_bits(lcps, g, lcp_width)
        row_len = (g[:, None] >= sec[None, :]).sum(dim=1)
        store_len = (row_len - len_off).clamp(0, sigma)
        lcp = torch.minimum(lcp, store_len)
        stored = extract_bits(payload, off[:, None] + (j - lcp[:, None]), term_bits)
        prev = torch.where(j < lcp[:, None], prev,
                           torch.where(j < store_len[:, None], stored, 0))
        off = off + store_len - lcp
        yield row_len, prev.to(torch.int32)


def block_expand_ref(lcps: torch.Tensor, payload: torch.Tensor,
                     block_base: torch.Tensor, sec_starts: torch.Tensor,
                     blk: torch.Tensor, *, term_bits: int, lcp_width: int,
                     block_size: int, len_off: int, out: torch.Tensor | None = None,
                     vocab_size: int | None = None) -> torch.Tensor:
    """Decoded term matrix [B, block_size, sigma] int32 of the requested blocks.

    Streams are int32 tensors holding uint32 words; ``sec_starts`` [sigma+1]
    int32 section starts give each row's length key; ``len_off`` is 0 for the
    point view, 1 for the continuation (prefix) view.  With ``out`` ([n,
    n_lanes] int64, n <= B * block_size) the first n decoded rows are packed
    with ``vocab_size`` (``pack_terms``) into ``out``, which is returned.
    """
    rows = [row for _, row in _front_coded_rows(
        lcps, payload, block_base, sec_starts, blk, term_bits=term_bits,
        lcp_width=lcp_width, block_size=block_size, len_off=len_off)]
    terms = torch.stack(rows, dim=1)
    if out is None:
        return terms
    sigma = terms.shape[2]
    out.copy_(packing.pack_terms(terms.reshape(-1, sigma)[:out.shape[0]],
                                 vocab_size=vocab_size))
    return out


def block_decode_ref(lcps: torch.Tensor, payload: torch.Tensor,
                     block_base: torch.Tensor, sec_starts: torch.Tensor,
                     blk: torch.Tensor, q_terms: torch.Tensor,
                     q_len: torch.Tensor, *, term_bits: int, lcp_width: int,
                     block_size: int, len_off: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cnt_lt [Q], cnt_eq [Q]) int32: rows of each query's candidate block
    whose (row_len, terms) key sorts strictly below / equal to the query's."""
    qt = q_terms.to(torch.int32)
    ql = q_len.to(torch.int64)
    cnt_lt = torch.zeros(blk.shape, dtype=torch.int32, device=blk.device)
    cnt_eq = torch.zeros_like(cnt_lt)
    for row_len, cur in _front_coded_rows(
            lcps, payload, block_base, sec_starts, blk, term_bits=term_bits,
            lcp_width=lcp_width, block_size=block_size, len_off=len_off):
        eq = cur == qt
        prefix_eq = torch.cumprod(
            torch.cat([torch.ones_like(eq[:, :1]), eq[:, :-1]], dim=1)
            .to(torch.int32), dim=1).to(torch.bool)
        t_lt = (prefix_eq & (cur < qt)).any(dim=1)
        len_eq = row_len == ql
        cnt_lt += ((row_len < ql) | (len_eq & t_lt)).to(torch.int32)
        cnt_eq += (len_eq & eq.all(dim=1)).to(torch.int32)
    return cnt_lt, cnt_eq
