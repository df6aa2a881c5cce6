"""Compressed index layout: front-coded blocks + Elias-Fano monotone structures
(port of ``repro.index.compress``).

**Front-coded blocks.**  Rows are cut into fixed ``block_size`` blocks.  Each
block stores its first row as a dense search key (the *head*) and every row
as ``(lcp, suffix terms)`` against its predecessor: lcp values in a
nibble/byte stream, suffix terms in a ``bits_for_vocab``-wide stream, and a
per-block base offset into the term stream.  Queries search the heads with
the ``bsearch`` kernel and rank inside the candidate block with the
``block_decode`` kernel; compaction decodes whole blocks with the
``block_expand`` kernel (:func:`decode_segment`).

**Elias-Fano.**  Section starts, the continuation fanout table and
``cont_cumsum`` are kept as unary high words + a per-word rank directory +
packed low bits: the at-rest form.  The query path reads decoded caches of
them (``sec_cache``, ``cumsum_cache``, ``fan_cache``, ``cont_fan_cache``).

Storage.  The packed streams (heads, lcp, payload, block bases, counts,
next terms, and the Elias-Fano low/high/rank words) are ``torch.int32``
tensors holding the uint32 bit pattern, so :attr:`nbytes_at_rest` equals
``repro``'s byte for byte; plain code widens a word to int64 and masks it
with ``U32`` before any shift (``kernels.bitpack``), the kernels read the
words as ``uint32_t``.  The ``bsearch`` kernel takes int64 lanes, so the
index also keeps a resident int64 copy of both head arrays (``head_lanes``,
``cont_head_lanes``), counted in :attr:`nbytes` but not at rest -- one copy
at build instead of a converted copy per query batch.  The decoded caches
are int32 (``sec_cache``, the fanout caches, in blocks) and int64
(``cumsum_cache``).

The build runs in torch on the index's device (``repro``'s is host numpy;
the bytes are the same).  Row order, sentinel padding and tie-breaks are inherited
exactly from the flat index: :func:`compress_index` is a pure re-encoding,
and every query answers bit-identically to the flat layout.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import U32, resolve_device, u32_words
from repro_torch.core.stats import NGramStats
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.bitpack import as_words, extract_bits, pack_words
from repro_torch.kernels.ref import search_steps
from repro_torch.mapreduce import pack as packing
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ._layout import SENTINEL, pad_rows, row_lengths
from .build import IndexSegment, NGramIndex, build_index

__all__ = ["EliasFano", "CompressedNGramIndex", "lcp_width_for",
           "head_key_layout", "compress_index", "build_compressed_index",
           "compressed_index_from_arrays", "decode_segment", "decode_view"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------- #
# Elias-Fano
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class EliasFano:
    """Monotone non-decreasing uint sequence in ~(2 + log2(U/n)) bits/value.

    ``high`` holds the unary upper parts (one i sits at bit ``i + (v_i >> l)``),
    ``word_rank`` the cumulative popcount per high word (the select
    directory), ``low`` the packed ``low_bits``-wide lower parts; all three
    are int32 tensors of uint32 words.
    """

    low: torch.Tensor        # [lw] packed low bits
    high: torch.Tensor       # [hw] unary high bits
    word_rank: torch.Tensor  # [hw+1] cumulative popcount of ``high``
    n: int
    low_bits: int
    universe: int

    @staticmethod
    def encode(values, universe: int | None = None, *,
               device=None) -> "EliasFano":
        """Encode ``values`` (a tensor or an array of non-negative integers)
        in torch on ``device`` (the card unless told otherwise)."""
        device = resolve_device(device)
        if not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values).astype(np.int64))
        v = values.reshape(-1).to(device=device, dtype=torch.int64)
        n = int(v.shape[0])
        if n == 0:
            raise ValueError("cannot Elias-Fano encode an empty sequence")
        if n > 1 and bool((v[1:] < v[:-1]).any()):
            raise ValueError("sequence is not monotone non-decreasing")
        v_min, v_max = (int(x) for x in torch.aminmax(v))
        if v_min < 0:
            raise ValueError(f"negative value {v_min} in an Elias-Fano sequence")
        u = v_max if universe is None else int(universe)
        if u < v_max:
            raise ValueError(f"universe {u} < max value {v_max}")
        l = max(0, int(math.floor(math.log2(max(u, 1) / n))) if u > n else 0)
        l = min(l, 31)
        low = pack_words(v & ((1 << l) - 1), l)
        ones = torch.arange(n, dtype=torch.int64, device=device) + (v >> l)
        n_bits = n + (u >> l) + 1
        hw = max(1, -(-n_bits // 32))
        # the ones are strictly increasing, so each is a distinct bit: a sum
        # of them is their OR, and a word's rank is a search over them
        high = torch.zeros(hw, dtype=torch.int64, device=device).index_add_(
            0, ones >> 5, torch.ones_like(ones) << (ones & 31))
        word_rank = torch.searchsorted(
            ones >> 5, torch.arange(hw + 1, dtype=torch.int64, device=device)) & U32
        return EliasFano(low, u32_words(high, device), u32_words(word_rank, device),
                         n=n, low_bits=l, universe=u)

    def select(self, i: torch.Tensor) -> torch.Tensor:
        """Values [*i.shape] int64 at positions ``i`` (0 <= i < n)."""
        i = i.to(torch.int64) & U32
        rank = self.word_rank.to(torch.int64) & U32
        # word holding the i-th one: last w with word_rank[w] <= i
        w = (torch.searchsorted(rank, i, right=True) - 1).clamp(
            0, self.high.shape[0] - 1)
        rank_in = (i - rank[w]) & U32
        word = self.high[w].to(torch.int64) & U32
        bits = (word[..., None] >> torch.arange(32, device=i.device)) & 1
        bitpos = (torch.cumsum(bits, dim=-1) <= rank_in[..., None]).sum(dim=-1)
        high_val = (w * 32 + bitpos - i) & U32
        low_val = extract_bits(self.low, i, self.low_bits)
        return ((high_val << self.low_bits) | low_val) & U32

    def decode_all(self) -> torch.Tensor:
        """All n values [n] int64 in one pass over the high words."""
        dev = self.high.device
        words = self.high.to(torch.int64) & U32
        bits = (words[:, None] >> torch.arange(32, device=dev)) & 1    # [hw, 32]
        one_pos = torch.nonzero(bits.reshape(-1)).squeeze(1)[:self.n]
        high_val = one_pos - torch.arange(self.n, device=dev)
        low_val = extract_bits(self.low, torch.arange(self.n, device=dev),
                               self.low_bits)
        return ((high_val << self.low_bits) | low_val) & U32

    def select_many(self, i: torch.Tensor) -> torch.Tensor:
        """:meth:`select`, or a whole decode + gather once the batch holds at
        least a quarter as many selects as the sequence has values."""
        if self.n <= 4 * i.numel():
            return self.decode_all()[i.to(torch.int64).clamp(0, self.n - 1)]
        return self.select(i)

    @property
    def nbytes(self) -> int:
        return sum(_nbytes(a) for a in (self.low, self.high, self.word_rank))


# --------------------------------------------------------------------------- #
# Compressed index
# --------------------------------------------------------------------------- #

def lcp_width_for(sigma: int) -> int:
    """Nibble for sigma <= 14, byte beyond: lcp values never straddle a word."""
    if sigma <= 14:
        return 4
    if sigma <= 254:
        return 8
    raise ValueError(f"sigma {sigma} out of supported range")


@dataclasses.dataclass(frozen=True)
class CompressedNGramIndex:
    """Front-coded + Elias-Fano re-encoding of an :class:`NGramIndex`.

    Same logical rows in the same order (sentinels included); every query
    answers bit-identically to the flat index.
    """

    # --- point-lookup view ------------------------------------------------------
    heads: torch.Tensor          # [nb, HL] dense (row_len | terms) head keys
    lcps: torch.Tensor           # packed lcp stream, lcp_width bits/row
    payload: torch.Tensor        # packed suffix-term stream, term_bits bits/term
    block_base: torch.Tensor     # [nb+1] cumulative suffix terms per block
    counts_packed: torch.Tensor  # packed cf stream, count_width bits/row
    ef_section: EliasFano        # section_start (sigma+1 values, universe=size)
    # --- continuation view ------------------------------------------------------
    cont_heads: torch.Tensor     # [nb, HL] dense (gram len | prefix) head keys
    cont_lcps: torch.Tensor
    cont_payload: torch.Tensor
    cont_block_base: torch.Tensor
    cont_last_packed: torch.Tensor    # packed next-term stream, term_bits bits/row
    cont_counts_packed: torch.Tensor  # packed cf stream, count_width bits/row
    ef_cont_fanout: EliasFano
    ef_cumsum: EliasFano         # cont_cumsum (size+1 values)
    # --- resident query state, derived from the streams (not at rest) ---------
    head_lanes: torch.Tensor       # [nb, HL] int64 copy of ``heads`` (bsearch)
    cont_head_lanes: torch.Tensor  # [nb, HL] int64 copy of ``cont_heads``
    sec_cache: torch.Tensor        # [sigma+1] int32 decoded section starts
    cumsum_cache: torch.Tensor     # [size+1] int64 decoded cont_cumsum
    fan_cache: torch.Tensor        # [sigma*(n_fanout+1)] int32 bracket blocks
    cont_fan_cache: torch.Tensor   # [sigma*(n_fanout+1)] int32 bracket blocks
    # --- static meta ------------------------------------------------------------
    sigma: int
    vocab_size: int
    size: int
    fanout_shift: int
    n_fanout: int
    block_size: int
    head_span: int
    head_steps: int
    term_bits: int
    count_width: int
    lcp_width: int

    @property
    def n_lanes(self) -> int:
        return packing.n_lanes(self.sigma, self.vocab_size)

    @property
    def n_blocks(self) -> int:
        return self.size // self.block_size

    @property
    def n_rows(self) -> int:
        """Real (non-sentinel) rows; the last section end."""
        return int(self.sec_cache[-1])

    @property
    def device(self) -> torch.device:
        return self.payload.device

    @property
    def nbytes_at_rest(self) -> int:
        """Bytes of the persisted artifact: the front-coded / bit-packed
        streams plus the Elias-Fano directories (``repro``'s number)."""
        arrays = (self.heads, self.lcps, self.payload, self.block_base,
                  self.counts_packed, self.cont_heads, self.cont_lcps,
                  self.cont_payload, self.cont_block_base,
                  self.cont_last_packed, self.cont_counts_packed)
        efs = (self.ef_section, self.ef_cont_fanout, self.ef_cumsum)
        return sum(_nbytes(a) for a in arrays) + sum(e.nbytes for e in efs)

    @property
    def nbytes(self) -> int:
        """Resident bytes: the at-rest streams plus the query state."""
        resident = (self.head_lanes, self.cont_head_lanes, self.sec_cache,
                    self.cumsum_cache, self.fan_cache, self.cont_fan_cache)
        return self.nbytes_at_rest + sum(_nbytes(a) for a in resident)

    def section_starts(self) -> torch.Tensor:
        """Decoded [sigma+1] int32 section starts (the in-block length key)."""
        return self.sec_cache

    def to_segment(self) -> IndexSegment:
        """The point view decoded back into the capacity-padded sorted segment."""
        seg = decode_segment(self)
        return IndexSegment(keys=pad_rows(seg.keys, self.size, SENTINEL),
                            counts=pad_rows(seg.counts, self.size, 0),
                            sigma=self.sigma, vocab_size=self.vocab_size)


# rows decoded per block_expand launch by decode_segment; module-level so
# tests can shrink it and assert the working-set bound.  Worked out for the
# H100.  A row reads a few bytes of streams (a 4-8 bit lcp, its stored suffix
# terms of term_bits each, a 4-byte block base per block) and its n_lanes int64
# lanes (24 bytes at sigma 5) go straight into the segment's key matrix, which
# the decode fills whatever the chunk; beyond that matrix a chunk holds only
# its block ids, 4 bytes a block, at most a quarter of the bytes its rows take
# in the key matrix.  The card keeps 132 SMs x 2,048 threads = 270,336 lanes
# resident, one row a lane in the group decode (block_size 4), so a chunk of
# 2**22 rows is ~16 such waves and ~100 MB of lane writes (~30 us at
# 3.35 TB/s), against a few us of host and launch cost per chunk.  Every
# rung of the streaming path (67k-375k rows) decodes in one launch.
_DECODE_CHUNK_ROWS = 1 << 22
# peak rows of any single decode chunk.  The chunk no longer materializes
# its rows anywhere but in the key matrix, so this now bounds only the block
# ids of one launch (repro's "compaction never decodes a full table" tests
# read it as the chunk's width)
_DECODE_WATERMARK = {"rows": 0}


def decode_segment(cidx: CompressedNGramIndex, *,
                   chunk_rows: int | None = None) -> IndexSegment:
    """Stream the point view back into an **unpadded** :class:`IndexSegment`
    on the index's device.

    Blocks decode ``chunk_rows`` rows at a time, one ``block_expand`` launch
    each, which packs the rows' lanes straight into the segment's keys (the
    tail chunk clips block ids to the last block and writes only real rows),
    so the decode's working set beyond the keys is one chunk's block ids.
    The decode work is attributed to the metrics registry
    (``merge.blocks_decoded`` / ``compress.rows_decoded``).
    """
    b = cidx.block_size
    r = cidx.n_rows
    dev = cidx.device
    nb_used = -(-r // b)                       # blocks holding real rows
    cb = max(1, (chunk_rows if chunk_rows is not None
                 else _DECODE_CHUNK_ROWS) // b)
    # never wider than the table: an oversized chunk would decode the
    # clamped filler blocks over and over
    cb = min(cb, max(nb_used, 1))
    keys = torch.empty((r, 1 + cidx.n_lanes), dtype=torch.int64, device=dev)
    keys[:, 0] = row_lengths(cidx.sec_cache, cidx.size)[:r]
    with obs_trace.span("compress.decode") as sp:
        if sp:
            sp.set(rows=r, blocks=nb_used, chunk_blocks=cb)
        for c0 in range(0, nb_used, cb):
            ids = torch.arange(c0, c0 + cb, dtype=torch.int32, device=dev).clamp(
                max=max(cidx.n_blocks - 1, 0))
            kops.block_expand(cidx.lcps, cidx.payload, cidx.block_base,
                              cidx.sec_cache, ids, term_bits=cidx.term_bits,
                              lcp_width=cidx.lcp_width, block_size=b, len_off=0,
                              out=keys[c0 * b:min((c0 + cb) * b, r), 1:],
                              vocab_size=cidx.vocab_size)
            _DECODE_WATERMARK["rows"] = max(_DECODE_WATERMARK["rows"], cb * b)
        counts = extract_bits(cidx.counts_packed,
                              torch.arange(max(r, 1), device=dev),
                              cidx.count_width)[:r]
    reg = obs_metrics.get_registry()
    reg.counter("merge.blocks_decoded").add(nb_used)
    reg.counter("compress.rows_decoded").add(r)
    return IndexSegment(keys=keys, counts=counts, sigma=cidx.sigma,
                        vocab_size=cidx.vocab_size)


def head_key_layout(sigma: int, term_bits: int):
    """((offset, width) per field, n_lanes) of the dense head search key:
    (row_len, t0..t_{sigma-1}) concatenated MSB-first with no per-lane slack,
    split into uint32 lanes.  Lex order over the lanes equals lex order over
    (row_len, terms), the flat index's row order."""
    len_bits = (sigma + 1).bit_length()     # row_len <= sigma+1 (sentinels)
    widths = [len_bits] + [term_bits] * sigma
    offs, o = [], 0
    for w in widths:
        offs.append(o)
        o += w
    return tuple(zip(offs, widths)), -(-o // 32)


def _pack_head_keys(row_len: torch.Tensor, terms: torch.Tensor,
                    *, term_bits: int) -> torch.Tensor:
    """[n, HL] int64 dense head keys of uint32 values (build side of
    :func:`head_key_layout`; ``query._dense_qkey`` is the query side -- the
    two must pack bit-identically)."""
    n, sigma = terms.shape
    fields, hl = head_key_layout(sigma, term_bits)
    lanes = torch.zeros((n, hl), dtype=torch.int64, device=terms.device)
    cols = [row_len] + [terms[:, j] for j in range(sigma)]
    for (o, w), v in zip(fields, cols):
        v = v.to(torch.int64) & ((1 << w) - 1)
        r = o + w
        j0 = o // 32
        e0 = 32 * (j0 + 1)
        if r <= e0:
            lanes[:, j0] |= (v << (e0 - r)) & U32
        else:                       # field straddles a lane boundary
            lanes[:, j0] |= v >> (r - e0)
            e1 = 32 * ((r - 1) // 32 + 1)
            lanes[:, (r - 1) // 32] |= (v << (e1 - r)) & U32
    return lanes


def _lcp(terms: torch.Tensor) -> torch.Tensor:
    """lcp[i] = common prefix length of sorted rows i and i-1 (lcp[0] = 0)."""
    lcp = torch.zeros(terms.shape[0], dtype=torch.int32, device=terms.device)
    if terms.shape[0] > 1:
        eq = (terms[1:] == terms[:-1]).to(torch.int32)
        lcp[1:] = torch.cumprod(eq, dim=1).sum(dim=1, dtype=torch.int32)
    return lcp


def _front_code(terms: torch.Tensor, row_len: torch.Tensor,
                *, len_off: int, block_size: int, term_bits: int,
                lcp_width: int, payload_words: int | None):
    """(heads [nb, HL] int64 of uint32 values, lcps, payload, block_base
    word tensors) of one view, built in torch on the terms' device.

    terms  : [size, S] int32 decoded term rows (view order, sentinels included)
    len_off: 0 for the point view, 1 for the continuation (prefix) view --
             stored terms per row = clip(row_len - len_off, 0, S).
    """
    size, sigma = terms.shape
    b = block_size
    if size % b:
        raise ValueError(f"size {size} not a multiple of block_size {b}")
    dev = terms.device
    store_len = (row_len - len_off).clamp(0, sigma).to(torch.int32)
    lcp = torch.minimum(_lcp(terms), store_len)
    lcp[0::b] = 0                      # block heads restart the coding chain
    j = torch.arange(sigma, device=dev)[None, :]
    stored_mask = (j >= lcp[:, None]) & (j < store_len[:, None])
    suffix = terms[stored_mask]                     # row-major
    cum = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    cum[1:] = torch.cumsum(store_len - lcp, dim=0, dtype=torch.int64)
    block_base = u32_words(cum[0::b], dev)          # [nb+1]: size % b == 0
    payload = pack_words(suffix, term_bits, n_words=payload_words)
    lcps = pack_words(lcp, lcp_width)
    heads = _pack_head_keys(row_len[0::b], terms[0::b], term_bits=term_bits)
    return heads, lcps, payload, block_base


def compress_index(idx: NGramIndex, *, block_size: int = 4,
                   count_width: int | None = None,
                   payload_words: int | None = None,
                   cont_payload_words: int | None = None,
                   cumsum_universe: int | None = None,
                   head_span: int | None = None,
                   device=None) -> CompressedNGramIndex:
    """Re-encode ``idx`` losslessly, in torch on ``device``.

    Runs on the card unless ``device`` says otherwise; with no card and no
    ``device`` it raises.  The capacity overrides force common array shapes
    across separately built indexes, as in ``repro``.
    """
    device = resolve_device(device)
    sigma, vocab, size = idx.sigma, idx.vocab_size, idx.size
    tb = packing.bits_for_vocab(vocab)
    lw = lcp_width_for(sigma)

    def on(t):
        return t.to(device=device, dtype=torch.int64)

    section_start = on(idx.section_start)
    row_len = row_lengths(section_start, size)
    counts = on(idx.counts) & U32
    cw = count_width if count_width is not None else \
        max(1, int(counts.max()).bit_length() if counts.numel() else 1)

    terms = packing.unpack_terms(on(idx.lanes) & U32, vocab_size=vocab, sigma=sigma)
    heads, lcps, payload, block_base = _front_code(
        terms, row_len, len_off=0, block_size=block_size,
        term_bits=tb, lcp_width=lw, payload_words=payload_words)
    c_terms = packing.unpack_terms(on(idx.cont_prefix) & U32, vocab_size=vocab,
                                   sigma=sigma)
    c_heads, c_lcps, c_payload, c_block_base = _front_code(
        c_terms, row_len, len_off=1, block_size=block_size,
        term_bits=tb, lcp_width=lw, payload_words=cont_payload_words)
    del terms, c_terms

    fan_t, c_fan_t = on(idx.fanout), on(idx.cont_fanout)
    fan, c_fan = fan_t.reshape(-1), c_fan_t.reshape(-1)
    if head_span is None:
        # widest fanout cell measured in blocks (+1 for a cell straddling one
        # more block boundary than its row count suggests): the head search
        # runs search_steps(head_span) trips instead of log2(n_blocks)
        head_span = 1
        for t in (fan_t, c_fan_t):
            if t.numel():
                head_span = max(head_span, int(torch.max(
                    -(-t[:, 1:] // block_size) - t[:, :-1] // block_size)) + 1)
        head_span = min(head_span, size // block_size)
    cumsum = on(idx.cont_cumsum)
    for name, seq in (("fanout", fan), ("cont_fanout", c_fan)):
        if seq.numel() > 1 and bool((seq[1:] < seq[:-1]).any()):
            raise AssertionError(f"{name} table is not monotone when flattened")

    return CompressedNGramIndex(
        heads=u32_words(heads, device), lcps=lcps, payload=payload,
        block_base=block_base,
        counts_packed=pack_words(counts, cw),
        ef_section=EliasFano.encode(section_start, universe=size, device=device),
        cont_heads=u32_words(c_heads, device), cont_lcps=c_lcps,
        cont_payload=c_payload, cont_block_base=c_block_base,
        cont_last_packed=pack_words(on(idx.cont_last) & U32, tb),
        cont_counts_packed=pack_words(on(idx.cont_counts) & U32, cw),
        ef_cont_fanout=EliasFano.encode(c_fan, universe=size, device=device),
        ef_cumsum=EliasFano.encode(
            cumsum, universe=cumsum_universe if cumsum_universe is not None
            else int(cumsum[-1]), device=device),
        head_lanes=heads,
        cont_head_lanes=c_heads,
        sec_cache=section_start.to(torch.int32),
        cumsum_cache=cumsum,
        fan_cache=(fan // block_size).to(torch.int32),
        cont_fan_cache=(c_fan // block_size).to(torch.int32),
        sigma=sigma, vocab_size=vocab, size=size,
        fanout_shift=idx.fanout_shift, n_fanout=idx.n_fanout,
        block_size=block_size, head_span=head_span,
        head_steps=search_steps(head_span),
        term_bits=tb, count_width=cw, lcp_width=lw,
    )


def build_compressed_index(stats: NGramStats, *, vocab_size: int,
                           pad_to: int | None = None, block_size: int = 4,
                           device=None) -> CompressedNGramIndex:
    """Job output -> compressed index (freeze flat, then re-encode)."""
    return compress_index(build_index(stats, vocab_size=vocab_size,
                                      pad_to=pad_to, device=device),
                          block_size=block_size, device=device)


#: uint32 stream arrays of a compressed index, in at-rest order
STREAMS = ("heads", "lcps", "payload", "block_base", "counts_packed",
           "cont_heads", "cont_lcps", "cont_payload", "cont_block_base",
           "cont_last_packed", "cont_counts_packed")
#: Elias-Fano members and the parts each carries
EF_FIELDS = ("ef_section", "ef_cont_fanout", "ef_cumsum")
#: static meta of a compressed index
META = ("sigma", "vocab_size", "size", "fanout_shift", "n_fanout", "block_size",
        "head_span", "head_steps", "term_bits", "count_width", "lcp_width")


def compressed_index_from_arrays(arrays: dict, meta: dict, *,
                                 device=None) -> CompressedNGramIndex:
    """A :class:`CompressedNGramIndex` over arrays laid out as ``repro``'s.

    ``arrays`` holds every name of :data:`STREAMS` (uint32 words), each
    Elias-Fano member of :data:`EF_FIELDS` as a dict of ``low``, ``high``,
    ``word_rank``, ``n``, ``low_bits`` and ``universe``, and the decoded
    caches ``sec_cache``, ``cumsum_cache``, ``fan_cache``, ``cont_fan_cache``;
    ``meta`` holds every name of :data:`META`.
    """
    device = resolve_device(device)

    def words(a):
        return as_words(np.asarray(a, np.uint32), device)

    def ints(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]).astype(dtype),
                               device=device)

    efs = {name: EliasFano(words(e["low"]), words(e["high"]),
                           words(e["word_rank"]), n=int(e["n"]),
                           low_bits=int(e["low_bits"]),
                           universe=int(e["universe"]))
           for name, e in ((n, arrays[n]) for n in EF_FIELDS)}
    heads = np.asarray(arrays["heads"], np.uint32)
    c_heads = np.asarray(arrays["cont_heads"], np.uint32)
    return CompressedNGramIndex(
        **{name: words(arrays[name]) for name in STREAMS}, **efs,
        head_lanes=torch.as_tensor(heads.astype(np.int64), device=device),
        cont_head_lanes=torch.as_tensor(c_heads.astype(np.int64), device=device),
        sec_cache=ints("sec_cache", np.int32),
        cumsum_cache=ints("cumsum_cache", np.int64),
        fan_cache=ints("fan_cache", np.int32),
        cont_fan_cache=ints("cont_fan_cache", np.int32),
        **{name: int(meta[name]) for name in META})


def decode_view(cidx: CompressedNGramIndex, view: str = "point") -> np.ndarray:
    """The full [size, S] int64 term matrix of one view (host, for tests):
    every block through the plain front-coding walk."""
    if view == "point":
        lcps, payload, base, len_off = (cidx.lcps, cidx.payload,
                                        cidx.block_base, 0)
    elif view == "cont":
        lcps, payload, base, len_off = (cidx.cont_lcps, cidx.cont_payload,
                                        cidx.cont_block_base, 1)
    else:
        raise ValueError(view)
    terms = kref.block_expand_ref(
        lcps.cpu(), payload.cpu(), base.cpu(), cidx.sec_cache.cpu(),
        torch.arange(cidx.n_blocks, dtype=torch.int32),
        term_bits=cidx.term_bits, lcp_width=cidx.lcp_width,
        block_size=cidx.block_size, len_off=len_off)
    return terms.reshape(cidx.size, cidx.sigma).numpy().astype(np.int64)

