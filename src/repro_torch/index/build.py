"""Freeze a finished SUFFIX-sigma job into a device-resident, queryable index
(port of the flat-index parts of ``repro.index.build``).

  * :func:`segment_from_stats` packs the rows into the shuffle/sort phases'
    own packed-lane format and sorts them into an :class:`IndexSegment`, the
    sorted immutable run of (length | lanes, cf) rows;
  * :func:`index_from_segment` derives the acceleration structures: per-length
    sections (``section_start``), the first-term fanout table that brackets a
    query's rows, and the continuation view -- the same rows ordered by
    (|gram|, packed prefix lanes, cf desc, next term asc) with its running
    mass ``cont_cumsum``.

Everything runs on the index's device.  Lanes and counts are int64 tensors
holding uint32 values (see the package docstring); tables of row offsets are
int32, as in ``repro``.  :func:`index_from_arrays` carries an index built by
``repro`` across, so both packages answer queries against the same state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import U32, resolve_device
from repro_torch.core.stats import NGramStats
from repro_torch.kernels.ref import search_steps  # re-export: queries need it
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import sort
from ._layout import SENTINEL, fanout_layout, pad_rows, round_capacity, row_offsets

__all__ = ["IndexSegment", "NGramIndex", "segment_from_stats",
           "segment_from_wave_stats", "index_from_segment", "build_index", "index_from_arrays",
           "search_steps"]


@dataclasses.dataclass(frozen=True)
class IndexSegment:
    """One sorted immutable run of n-gram rows -- the unit of merge.

    Rows are sorted by (length | packed lanes); rows 0..n_rows-1 are real,
    the tail is all-ones sentinel rows that sort after every real row.
    """

    keys: torch.Tensor    # [size, 1+L] int64 (uint32 values): (length | lanes)
    counts: torch.Tensor  # [size] int64 collection frequencies (0 on sentinels)
    sigma: int
    vocab_size: int

    @property
    def size(self) -> int:
        return int(self.keys.shape[-2])

    @property
    def n_lanes(self) -> int:
        return int(self.keys.shape[-1]) - 1

    @property
    def lanes(self) -> torch.Tensor:
        """Packed gram lanes [size, L] (a view: the length column stripped)."""
        return self.keys[..., 1:]

    @property
    def n_rows(self) -> int:
        """Real (non-sentinel) rows: lengths are the primary sort key."""
        return int((self.keys[:, 0] <= self.sigma).sum())

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def nbytes(self) -> int:
        """Resident bytes (int64 lanes and counts: twice ``repro``'s uint32)."""
        return sum(t.numel() * t.element_size() for t in (self.keys, self.counts))


@dataclasses.dataclass(frozen=True)
class NGramIndex:
    """Immutable device-resident n-gram index (see module docstring)."""

    # --- point-lookup view: the sorted segment itself ----------------------------
    segment: IndexSegment
    section_start: torch.Tensor  # [sigma+1] int32: section l+1 = rows [s[l], s[l+1])
    fanout: torch.Tensor         # [sigma, n_fanout+1] int32 lead-term bucket offsets
    # --- continuation view: rows sorted by (length, prefix lanes, cf desc) -------
    cont_prefix: torch.Tensor    # [size, L] int64 packed lanes of the length-1 prefix
    cont_last: torch.Tensor      # [size]    int64 final term of each gram
    cont_counts: torch.Tensor    # [size]    int64 cf, descending within prefix group
    cont_fanout: torch.Tensor    # [sigma, n_fanout+1] int32 prefix-lead bucket offsets
    cont_cumsum: torch.Tensor    # [size+1]  int64 running sum of cont_counts
    # --- static meta ---------------------------------------------------------------
    sigma: int
    vocab_size: int
    size: int
    fanout_shift: int
    n_fanout: int

    @property
    def lanes(self) -> torch.Tensor:
        """[size, L] packed gram lanes (the segment's, sans length)."""
        return self.segment.lanes

    @property
    def counts(self) -> torch.Tensor:
        return self.segment.counts

    @property
    def n_lanes(self) -> int:
        return self.segment.n_lanes

    @property
    def n_rows(self) -> int:
        """Real (non-sentinel) rows; the last section end."""
        return int(self.section_start[-1])

    @property
    def device(self) -> torch.device:
        return self.segment.keys.device

    @property
    def nbytes(self) -> int:
        """Resident bytes of every array (int64 where ``repro`` has uint32)."""
        return self.segment.nbytes + sum(t.numel() * t.element_size() for t in (
            self.section_start, self.fanout, self.cont_prefix, self.cont_last,
            self.cont_counts, self.cont_fanout, self.cont_cumsum))

    @property
    def nbytes_uint32(self) -> int:
        """Bytes of ``repro``'s layout of the same arrays (``repro``'s
        ``nbytes``): every element 4 bytes, lanes and counts uint32."""
        return 4 * sum(t.numel() for t in (
            self.segment.keys, self.segment.counts, self.section_start, self.fanout,
            self.cont_prefix, self.cont_last, self.cont_counts, self.cont_fanout,
            self.cont_cumsum))

    def to_segment(self) -> IndexSegment:
        """The point-view segment (shared tensors, no copy)."""
        return self.segment


def _sorted_rows(stats: NGramStats, vocab_size: int, device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A job's rows as sorted (length | packed lanes) keys and uint32 cf,
    on ``device``; bucketed series counts marginalize to cf."""
    counts = np.asarray(stats.counts)
    if counts.ndim == 2:
        counts = counts.sum(axis=1)
    grams = torch.as_tensor(np.asarray(stats.grams, np.int32), device=device)
    lengths = torch.as_tensor(np.asarray(stats.lengths, np.int64), device=device)
    counts = torch.as_tensor(counts.astype(np.int64) & U32, device=device)
    lanes = packing.pack_terms(grams, vocab_size=vocab_size)
    keys = torch.cat([(lengths & U32)[:, None], lanes], dim=1)
    keys_s, (counts_s,) = sort.sort_with_payload(keys, [counts])
    return keys_s, counts_s


def segment_from_stats(stats: NGramStats, *, vocab_size: int,
                       pad_to: int | None = None, device=None) -> IndexSegment:
    """Sort a finished job's rows into an :class:`IndexSegment` on ``device``.

    ``pad_to`` fixes the padded capacity (default rounds R+1 up to 128).
    """
    device = resolve_device(device)
    r, sigma = np.asarray(stats.grams).shape
    size = pad_to if pad_to is not None else round_capacity(r)
    if size < r + 1:
        raise ValueError(f"pad_to={size} < n_rows+1={r + 1}")
    keys_s, counts_s = _sorted_rows(stats, vocab_size, device)
    return IndexSegment(keys=pad_rows(keys_s, size, SENTINEL),
                        counts=pad_rows(counts_s, size, 0),
                        sigma=sigma, vocab_size=vocab_size)


def segment_from_wave_stats(stats: NGramStats, *, vocab_size: int,
                            device=None) -> IndexSegment:
    """Freeze one wave's partial into a sorted segment with no sentinel tail
    (the wave engine's stats route, for plans whose lanes pack with another
    vocabulary than the segment's).  Any route of ``merge_segments`` and
    ``GenerationalIndex.ingest_segment`` take it as it is."""
    keys_s, counts_s = _sorted_rows(stats, vocab_size, resolve_device(device))
    return IndexSegment(keys=keys_s, counts=counts_s,
                        sigma=int(np.asarray(stats.grams).shape[1]),
                        vocab_size=vocab_size)


def index_from_segment(seg: IndexSegment, *,
                       pad_to: int | None = None) -> NGramIndex:
    """Derive the acceleration structures of a sorted segment (on its device)."""
    sigma, vocab_size = seg.sigma, seg.vocab_size
    dev = seg.keys.device
    r = seg.n_rows
    keys = seg.keys[:r]
    counts_s = seg.counts[:r]
    len_s = keys[:, 0].contiguous()
    shift, n_fanout = fanout_layout(vocab_size)
    size = pad_to if pad_to is not None else round_capacity(r)
    if size < r + 1:
        raise ValueError(f"pad_to={size} < n_rows+1={r + 1}")

    grams = packing.unpack_terms(keys[:, 1:], vocab_size=vocab_size, sigma=sigma)
    lead_s = grams[:, 0].to(torch.int64)
    # combined (length, bucket) key is monotone: length is the primary sort key
    # and the lead term sits in lane 0's most-significant bits
    combined = len_s * n_fanout + (lead_s >> shift)
    section_start = row_offsets(len_s, torch.arange(1, sigma + 2, device=dev))
    grid = (torch.arange(1, sigma + 1, device=dev)[:, None] * n_fanout
            + torch.arange(n_fanout + 1, device=dev)[None, :]).reshape(-1)
    fanout = torch.minimum(
        row_offsets(combined, grid).reshape(sigma, n_fanout + 1),
        section_start[1:, None])

    # ---- continuation view: (length | prefix lanes | cf desc | next term) -------
    # the trailing next-term key breaks (prefix, cf) ties deterministically, so
    # the view depends only on the row *set*
    prefix = grams * (torch.arange(sigma, device=dev)[None, :] < (len_s - 1)[:, None])
    p_lanes = packing.pack_terms(prefix, vocab_size=vocab_size)
    last = (grams[torch.arange(r, device=dev), (len_s - 1).clamp(min=0)]
            .to(torch.int64) & U32)
    p_lead = prefix[:, 0].to(torch.int64)
    ckeys = torch.cat([len_s[:, None], p_lanes, (U32 - counts_s)[:, None],
                       last[:, None]], dim=1)
    ckeys_s, (c_counts_s, c_lead_s) = sort.sort_with_payload(
        ckeys, [counts_s, p_lead])
    n_l = seg.n_lanes
    c_combined = ckeys_s[:, 0] * n_fanout + (c_lead_s >> shift)
    cont_fanout = torch.minimum(
        row_offsets(c_combined, grid).reshape(sigma, n_fanout + 1),
        section_start[1:, None])
    # the total mass over all rows is ~sigma x corpus tokens and can exceed
    # uint32 even when every cf fits: refuse loudly rather than serve wrapped
    # continuation totals (repro's device cumsum is uint32)
    mass = torch.cumsum(c_counts_s, dim=0)
    if r and int(mass[-1]) > U32:
        raise ValueError(
            f"total continuation mass {int(mass[-1])} overflows the uint32 "
            "cumsum; shard the index or raise tau")
    cont_cumsum = torch.zeros((size + 1,), dtype=torch.int64, device=dev)
    if r:
        cont_cumsum[1:r + 1] = mass
        cont_cumsum[r + 1:] = mass[-1]

    return NGramIndex(
        segment=IndexSegment(keys=pad_rows(keys, size, SENTINEL),
                             counts=pad_rows(counts_s, size, 0),
                             sigma=sigma, vocab_size=vocab_size),
        section_start=section_start,
        fanout=fanout,
        cont_prefix=pad_rows(ckeys_s[:, 1:1 + n_l], size, SENTINEL),
        cont_last=pad_rows(ckeys_s[:, 2 + n_l], size, 0),
        cont_counts=pad_rows(c_counts_s, size, 0),
        cont_fanout=cont_fanout,
        cont_cumsum=cont_cumsum,
        sigma=sigma, vocab_size=vocab_size, size=size,
        fanout_shift=shift, n_fanout=n_fanout,
    )


def build_index(stats: NGramStats, *, vocab_size: int,
                pad_to: int | None = None, device=None) -> NGramIndex:
    """Freeze ``stats`` (a finished job's output) into an :class:`NGramIndex`.

    Builds on the card unless ``device`` says otherwise; with no card and no
    ``device`` it raises rather than building on the CPU.
    """
    return index_from_segment(
        segment_from_stats(stats, vocab_size=vocab_size, pad_to=pad_to,
                           device=device),
        pad_to=pad_to)


def index_from_arrays(arrays: dict[str, np.ndarray], *, sigma: int,
                      vocab_size: int, fanout_shift: int, n_fanout: int,
                      device=None) -> NGramIndex:
    """An :class:`NGramIndex` over arrays laid out as ``repro``'s index.

    ``arrays`` holds ``keys`` and ``counts`` (the point segment),
    ``section_start``, ``fanout``, ``cont_prefix``, ``cont_last``,
    ``cont_counts``, ``cont_fanout`` and ``cont_cumsum`` -- uint32 values
    become int64 tensors, row offsets int32.
    """
    device = resolve_device(device)

    def values(name):
        return torch.as_tensor(np.asarray(arrays[name]).astype(np.int64),
                               device=device)

    def offsets(name):
        return torch.as_tensor(np.asarray(arrays[name]).astype(np.int32),
                               device=device)

    keys = values("keys")
    return NGramIndex(
        segment=IndexSegment(keys=keys, counts=values("counts"), sigma=sigma,
                             vocab_size=vocab_size),
        section_start=offsets("section_start"),
        fanout=offsets("fanout"),
        cont_prefix=values("cont_prefix"),
        cont_last=values("cont_last"),
        cont_counts=values("cont_counts"),
        cont_fanout=offsets("cont_fanout"),
        cont_cumsum=values("cont_cumsum"),
        sigma=sigma, vocab_size=vocab_size, size=int(keys.shape[0]),
        fanout_shift=fanout_shift, n_fanout=n_fanout,
    )
