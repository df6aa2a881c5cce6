"""Incremental index maintenance: k-way segment merge, the wave engine's
segment accumulators, and the generational (LSM) index (port of
``repro.index.merge``).

  * :func:`merge_segments` -- merge sorted segments into one, summing the
    counts of duplicate grams.  Routes: ``"merge"`` runs the ``merge_path``
    kernel over a balanced pairing tree (``"device"`` is another name for
    it: the port has no size ceiling that sends a device merge to the host),
    ``"sort"`` re-sorts the concatenation, and ``"kway"`` folds on the host
    exploiting the inputs' sortedness -- the one host route, taken only when
    the caller names it.  On the device routes the dedup fold takes run
    totals from one int64 running sum (exact for any run length: the port's
    counts are int64, where ``repro`` needs two uint32 limbs).  Every route
    raises the same ``ValueError`` as ``repro`` if a merged cf exceeds
    2**32 - 1, and all produce identical segments: ascending (length |
    packed lanes), a pure function of the row set.
  * :func:`merge_indexes` -- segments in, finished index out, re-compressed
    when the inputs were compressed; ``merge(build(A), build(B))`` equals
    ``build(A u B)`` array for array.
  * :class:`DeferredSegmentAccumulator`, :class:`TieredSegmentAccumulator`,
    :class:`PairwiseSegmentAccumulator` -- fold a stream of wave segments
    into one (``pipeline.executor.WaveExecutor.run``): once at the end, as
    size-tiered rungs, or into one segment every wave.  Each counts the rows
    it feeds through merges (``fold_rows``) exactly as ``repro``'s does.
  * :class:`GenerationalIndex` -- L0..Ln immutable segments under size-ratio
    compaction.  Each ingest freezes a job delta into a fresh L0; merges
    cascade while the newest run has grown to within ``size_ratio`` of its
    elder.  With ``compress=True`` merged rungs freeze to the compressed
    layout and fresh L0 deltas stay flat; compaction stream-decodes
    compressed inputs chunk by chunk (``decode_segment``).

Segments live on the index's device as int64 tensors of uint32 values (a
wave's segment has no sentinel tail); the host routes go through numpy and
hand the result back to that device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import U32, resolve_device
from repro_torch.core.stats import NGramStats
from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import sort as mr_sort
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from ._layout import SENTINEL, pad_rows, round_capacity, row_bytes_view
from .build import IndexSegment, index_from_segment, segment_from_stats
from .compress import CompressedNGramIndex, compress_index, decode_segment

DEFAULT_SIZE_RATIO = 4


def _overflow(count: int, row: int) -> ValueError:
    return ValueError(
        f"merged count {count} of gram row {row} overflows the uint32 device "
        "count lane; raise tau or shard the corpus before merging")


def _merged_run(segs: list[IndexSegment], *, route: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One sorted run (duplicates kept, sentinels at the tail) over all rows.

    ``segs`` is emptied as it is read, and the merge tree drops each pair of
    runs once merged: inputs that no caller holds are freed level by level,
    so the tree holds at most its inputs and one merged pair at a time.
    """
    if route == "sort":
        keys = torch.cat([s.keys for s in segs], dim=0)
        counts = torch.cat([s.counts for s in segs], dim=0)
        segs.clear()
        keys, (counts,) = mr_sort.sort_with_payload(keys, [counts])
        return keys, counts
    if route in ("merge", "device"):
        # balanced pairing tree in segment order: every row rides O(log k)
        # pairwise merges, and adjacent pairing + the A-first tie rule keep
        # duplicates in generation order (moot: the fold sums them)
        runs = [(s.keys, s.counts) for s in segs]
        segs.clear()
        while len(runs) > 1:
            level, runs = runs, []
            while len(level) > 1:
                (ak, av), (bk, bv) = level.pop(0), level.pop(0)
                runs.append(kops.merge_path(ak, bk, av, bv))
                del ak, av, bk, bv
            runs += level
        return runs[0]
    raise ValueError(f"unknown merge route {route!r}")


def _fold_runs_device(keys: torch.Tensor, counts: torch.Tensor, *, sigma: int,
                      pad_to: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dedup-fold a sorted run on its device -> (keys, int64 totals), padded
    with sentinel rows to ``pad_to`` (default ``round_capacity``).

    Run totals are differences of one running sum at the run ends, and the
    real runs (sentinels sort last) are gathered straight into the padded
    output: besides the run, the fold holds the sum and per-run vectors
    only.  Raises ``ValueError`` if a total exceeds uint32.
    """
    n = keys.shape[0]
    new_run = torch.ones((n,), dtype=torch.bool, device=keys.device)
    if n > 1:
        new_run[1:] = (keys[1:] != keys[:-1]).any(dim=1)
    starts = torch.nonzero(new_run).squeeze(1)
    del new_run
    r = int((keys[starts, 0] <= sigma).sum())
    csum = torch.cumsum(counts, dim=0)
    below = torch.where(starts[:r] > 0, csum[(starts[:r] - 1).clamp(min=0)], 0)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])[:r] - 1
    totals = csum[ends] - below
    del csum, below, ends
    # a silently wrapped cf would serve plausible-looking garbage
    if r and int(totals.max()) > U32:
        bad = int(totals.argmax())
        raise _overflow(int(totals[bad]), bad)
    size = pad_to if pad_to is not None else round_capacity(r)
    if size < r + 1:
        raise ValueError(f"pad_to={size} < n_rows+1={r + 1}")
    out_keys = keys.new_full((size, keys.shape[1]), SENTINEL)
    torch.index_select(keys, 0, starts[:r], out=out_keys[:r])
    return out_keys, pad_rows(totals, size, 0)


def _check_u32(totals: np.ndarray) -> np.ndarray:
    """int64 merged counts, refusing loudly past uint32."""
    if totals.size and int(totals.max()) > U32:
        bad = int(np.argmax(totals))
        raise _overflow(int(totals[bad]), bad)
    return totals


def _host_rows(seg: IndexSegment) -> tuple[np.ndarray, np.ndarray]:
    """(uint32 keys, int64 counts) of a segment's real rows, on the host."""
    r = seg.n_rows
    return (seg.keys[:r].cpu().numpy().astype(np.uint32),
            seg.counts[:r].cpu().numpy().astype(np.int64))


def _sorted_unique(segs: list[IndexSegment]):
    """Merge + dedup-fold segments' real rows -> sorted (keys, int64 totals,
    row bytes).  A stable sort of the concatenated big-endian row bytes is a
    galloping k-way merge (numpy's timsort finds the k sorted runs)."""
    rows = [_host_rows(s) for s in segs]
    keys = np.concatenate([k for k, _ in rows], axis=0)
    counts = np.concatenate([c for _, c in rows], axis=0)
    row_bytes = row_bytes_view(keys)
    order = np.argsort(row_bytes, kind="stable")
    sorted_bytes = row_bytes[order]
    new_run = np.ones(order.shape[0], bool)
    new_run[1:] = sorted_bytes[1:] != sorted_bytes[:-1]
    starts = np.flatnonzero(new_run)
    if not starts.size:
        return (np.zeros((0, keys.shape[1]), np.uint32),
                np.zeros((0,), np.int64), np.zeros((0,), row_bytes.dtype))
    picked = order[starts]
    totals = np.add.reduceat(counts[order], starts)
    return keys[picked], totals, row_bytes[picked]


def _kway_fold_host(segs: list[IndexSegment]) -> tuple[np.ndarray, np.ndarray]:
    """Host k-way dedup fold that exploits the inputs' sortedness.

    Balanced inputs take one merge-by-stable-sort over every real row.
    Skewed inputs -- one segment at least as large as all others together,
    the shape of an LSM compaction -- sort only the small side and splice it
    into the base by binary search.
    """
    sizes = [s.n_rows for s in segs]
    b = int(np.argmax(sizes))
    nb, nd = sizes[b], sum(sizes) - sizes[b]
    if nd == 0:
        # one live input (plus empties): already sorted and unique
        return _host_rows(segs[b])
    if nb < nd:
        keys, totals, _ = _sorted_unique(segs)
        return keys, _check_u32(totals)
    d_keys, d_tot, d_bytes = _sorted_unique(segs[:b] + segs[b + 1:])
    b_keys, b_tot = _host_rows(segs[b])
    b_bytes = row_bytes_view(b_keys)
    # delta rows already in the base fold their counts in place; the rest
    # interleave at their insertion points via one shift-and-scatter
    pos = np.searchsorted(b_bytes, d_bytes, side="left")
    dup = np.zeros(d_bytes.shape[0], bool)
    in_range = pos < nb
    dup[in_range] = b_bytes[pos[in_range]] == d_bytes[in_range]
    b_tot[pos[dup]] += d_tot[dup]
    ins = pos[~dup]
    n_new = int(ins.shape[0])
    out_keys = np.empty((nb + n_new, b_keys.shape[1]), np.uint32)
    out_tot = np.empty((nb + n_new,), np.int64)
    new_at = ins + np.arange(n_new)
    base_at = np.arange(nb) + np.cumsum(np.bincount(ins, minlength=nb + 1))[:nb]
    out_keys[base_at] = b_keys
    out_tot[base_at] = b_tot
    out_keys[new_at] = d_keys[~dup]
    out_tot[new_at] = d_tot[~dup]
    return out_keys, _check_u32(out_tot)


def merge_segments(segments, *, route: str = "merge", pad_to: int | None = None,
                   n_compressed: int | None = None) -> IndexSegment:
    """Merge sorted segments into one, summing counts of duplicate grams.

    The result lies on the first segment's device.  ``n_compressed`` only
    annotates the ``merge.segments`` span with the flat/compressed input mix.
    Raises ``ValueError`` if any merged count overflows uint32.
    """
    return _merge_owned(list(segments), route=route, pad_to=pad_to,
                        n_compressed=n_compressed)


def _merge_owned(segs: list, *, route: str, pad_to: int | None = None,
                 n_compressed: int | None = None) -> IndexSegment:
    """:func:`merge_segments` over a list it may empty: the device routes
    free each input once merged, unless a caller still holds it (the
    accumulators hand their segments over this way)."""
    if not segs:
        raise ValueError("cannot merge zero segments")
    sigma, vocab = segs[0].sigma, segs[0].vocab_size
    for s in segs[1:]:
        if (s.sigma, s.vocab_size) != (sigma, vocab):
            raise ValueError(
                f"segment meta mismatch: ({s.sigma}, {s.vocab_size}) vs "
                f"({sigma}, {vocab})")
    if route not in ("kway", "merge", "device", "sort"):
        raise ValueError(f"unknown merge route {route!r}")
    dev = segs[0].keys.device
    with obs_trace.span("merge.segments") as sp:
        if sp:
            sp.set(n_segments=len(segs), rows_in=sum(s.size for s in segs))
            if n_compressed is not None:
                sp.set(n_compressed=n_compressed,
                       n_flat=len(segs) - n_compressed)
        if route != "kway":
            segs[:] = [IndexSegment(s.keys.to(dev), s.counts.to(dev), sigma, vocab)
                       for s in segs]
            keys, counts = _fold_runs_device(*_merged_run(segs, route=route),
                                             sigma=sigma, pad_to=pad_to)
            return IndexSegment(keys=keys, counts=counts, sigma=sigma,
                                vocab_size=vocab)
        r_keys, r_tot = _kway_fold_host(segs)
        r = int(r_keys.shape[0])
        size = pad_to if pad_to is not None else round_capacity(r)
        if size < r + 1:
            raise ValueError(f"pad_to={size} < n_rows+1={r + 1}")
        keys = torch.as_tensor(r_keys.astype(np.int64), device=dev)
        counts = torch.as_tensor(r_tot, device=dev)
        return IndexSegment(keys=pad_rows(keys, size, SENTINEL),
                            counts=pad_rows(counts, size, 0),
                            sigma=sigma, vocab_size=vocab)


def _merge_input_segment(entry, *, route: str) -> IndexSegment:
    """Segment view of one merge input: flat entries pass through; compressed
    ones stream-decode block chunks (``decode_segment``), unpadded for the
    host ``"kway"`` route, capacity-padded for the device routes."""
    if isinstance(entry, CompressedNGramIndex):
        return decode_segment(entry) if route == "kway" else entry.to_segment()
    return entry if isinstance(entry, IndexSegment) else entry.to_segment()


def merge_indexes(indexes, *, route: str = "merge", pad_to: int | None = None):
    """Merge finished indexes into one of the same layout, job-free.

    All inputs share (sigma, vocab_size) and layout; compressed inputs must
    agree on ``block_size`` and yield a compressed result on the first
    input's device.
    """
    ixs = list(indexes)
    if not ixs:
        raise ValueError("cannot merge zero indexes")
    compressed = isinstance(ixs[0], CompressedNGramIndex)
    for ix in ixs[1:]:
        if isinstance(ix, CompressedNGramIndex) != compressed:
            raise ValueError("cannot merge mixed flat/compressed layouts")
    seg = merge_segments([_merge_input_segment(ix, route=route) for ix in ixs],
                         route=route,
                         n_compressed=sum(isinstance(ix, CompressedNGramIndex)
                                          for ix in ixs))
    idx = index_from_segment(seg, pad_to=pad_to)
    if compressed:
        bs = {ix.block_size for ix in ixs}
        if len(bs) != 1:
            raise ValueError(f"mixed block_size across inputs: {sorted(bs)}")
        return compress_index(idx, block_size=bs.pop(), device=idx.device)
    return idx


def segment_to_stats(seg: IndexSegment, *,
                     min_count: int | None = None) -> NGramStats:
    """Host ``NGramStats`` view of a segment's real rows (``min_count``
    filters rows before the unpack)."""
    r = seg.n_rows
    keys = seg.keys[:r]
    counts = seg.counts[:r]
    if min_count is not None and min_count > 1:
        keep = counts >= min_count
        keys, counts = keys[keep], counts[keep]
    grams = packing.unpack_terms(keys[:, 1:], vocab_size=seg.vocab_size,
                                 sigma=seg.sigma)
    return NGramStats(grams.cpu().numpy().astype(np.int32),
                      keys[:, 0].cpu().numpy().astype(np.int32),
                      counts.cpu().numpy().astype(np.int64))


def stats_union(*stats: NGramStats) -> NGramStats:
    """Dedup-summed union of job outputs -- the from-scratch merge oracle."""
    acc: dict[tuple[int, ...], int] = {}
    sigma = max((int(s.grams.shape[1]) for s in stats), default=0)
    for s in stats:
        for g, v in s.to_dict().items():
            acc[g] = acc.get(g, 0) + v
    grams = np.zeros((len(acc), sigma), np.int32)
    lengths = np.zeros((len(acc),), np.int32)
    counts = np.zeros((len(acc),), np.int64)
    for i, (g, v) in enumerate(acc.items()):
        grams[i, :len(g)] = g
        lengths[i] = len(g)
        counts[i] = v
    return NGramStats(grams, lengths, counts)


def merge_continuation_results(per_seg, *, k: int):
    """Exact cross-segment fold of per-segment continuation answers.

    per_seg: list of (n_distinct [Q], total [Q], terms [Q, m], counts [Q, m])
    tensors, each holding a segment's *complete* continuation set of every
    query (every n_distinct <= m).  Returns (nd [Q], total [Q], terms [Q, k],
    counts [Q, k]) int64, per-term counts summed across segments and ranked
    (cf desc, term asc) -- the continuation view's tie order.
    """
    nd0 = per_seg[0][0]
    dev, q = nd0.device, nd0.shape[0]
    total = torch.zeros((q,), dtype=torch.int64, device=dev)
    terms_all, counts_all, qid_all = [], [], []
    for _, tot_i, t_i, c_i in per_seg:
        total += tot_i.to(torch.int64)
        live = c_i > 0
        qid = torch.arange(q, device=dev)[:, None].expand_as(t_i)
        terms_all.append(t_i[live].to(torch.int64))
        counts_all.append(c_i[live].to(torch.int64))
        qid_all.append(qid[live])
    terms, cfs, qid = (torch.cat(x) for x in (terms_all, counts_all, qid_all))
    span = int(terms.max()) + 2 if terms.numel() else 2
    uniq, inv = torch.unique(qid * span + terms, return_inverse=True)
    sums = torch.zeros(uniq.shape, dtype=torch.int64, device=dev)
    sums.index_add_(0, inv, cfs)
    # query-time mirror of the merge fold's guard
    worst = max(int(sums.max()) if sums.numel() else 0,
                int(total.max()) if total.numel() else 0)
    if worst > U32:
        raise ValueError(
            f"summed continuation mass {worst} across live segments overflows "
            "uint32; compact the index or raise tau")
    u_q, u_t = uniq // span, uniq % span
    nd = torch.bincount(u_q, minlength=q)
    # rank within each query: cf desc, term asc (stable sorts, last key first)
    order = torch.argsort(u_t, stable=True)
    order = order[torch.argsort(-sums[order], stable=True)]
    order = order[torch.argsort(u_q[order], stable=True)]
    starts = torch.cumsum(nd, dim=0) - nd
    rank = torch.arange(order.shape[0], device=dev) - starts[u_q[order]]
    keep = rank < k
    rows, cols = u_q[order][keep], rank[keep]
    topk_t = torch.zeros((q, k), dtype=torch.int64, device=dev)
    topk_c = torch.zeros((q, k), dtype=torch.int64, device=dev)
    topk_t[rows, cols] = u_t[order][keep]
    topk_c[rows, cols] = sums[order][keep]
    return nd, total, topk_t, topk_c


class TieredSegmentAccumulator:
    """Size-tiered fold of a stream of sorted segments (a wave accumulator).

    ``push`` stacks the new segment as the newest rung and merges while the
    newest rung has grown to within ``size_ratio`` of its elder, so equal
    waves amortize to O(total log waves) merge rows; ``result`` folds the
    rungs left.  Merges are associative and their order is a pure function of
    the row set, so the result equals every other accumulator's.
    ``fold_rows`` counts every input row fed through a merge, as ``repro``'s.

    ``global_rows``: on a rank that folds its own part of a row set split
    over ranks (the mesh waves), a callable mapping this rank's row count of
    a rung to the count over all ranks; the size ratio then decides on the
    whole rungs, so every rank merges when ``repro``'s one fold does and the
    ranks' ``fold_rows`` sum to its.
    """

    def __init__(self, *, size_ratio: int = DEFAULT_SIZE_RATIO,
                 route: str = "sort", global_rows=None):
        if size_ratio < 1:
            raise ValueError("size_ratio must be >= 1")
        self.size_ratio = size_ratio
        self.route = route
        self._global = global_rows or (lambda rows: rows)
        # newest first: (segment, its rows, the rung's rows over the ranks)
        self.rungs: list[tuple[IndexSegment, int, int]] = []
        self.fold_rows = 0

    def _merge_front(self, n: int) -> IndexSegment:
        segs = [s for s, _, _ in reversed(self.rungs[:n])]   # elder first
        self.fold_rows += sum(r for _, r, _ in self.rungs[:n])
        del self.rungs[:n]
        return _merge_owned(segs, route=self.route)

    def _stack(self, seg: IndexSegment, rows: int) -> None:
        self.rungs.insert(0, (seg, rows, self._global(rows)))

    def push(self, seg: IndexSegment, *, n_rows: int | None = None) -> None:
        """Stack one segment (of ``n_rows`` real rows, when the caller knows
        them), then compact rungs under the size-ratio policy."""
        self._stack(seg, seg.n_rows if n_rows is None else n_rows)
        while (len(self.rungs) >= 2 and
               self.rungs[0][2] * self.size_ratio >= self.rungs[1][2]):
            merged = self._merge_front(2)
            self._stack(merged, merged.n_rows)

    def result(self) -> IndexSegment:
        """Fold the remaining rungs into the one final sorted segment (no
        size is asked: nothing is decided after it)."""
        if not self.rungs:
            raise ValueError("no segments accumulated")
        if len(self.rungs) > 1:
            merged = self._merge_front(len(self.rungs))
            self.rungs = [(merged, merged.n_rows, None)]
        return self.rungs[0][0]


class DeferredSegmentAccumulator:
    """Stack every wave segment; fold once, k-way, at :meth:`result` (the
    wave engine's default): O(total) rows through one merge.

    All partials stay live until ``result``, the same order of memory as the
    merged segment itself.  ``route`` defaults to ``"merge"``, where
    ``repro``'s defaults to ``"kway"``: the port's ``kway`` folds on the
    host.  Same interface and result as the other accumulators.
    """

    def __init__(self, *, route: str = "merge", **_ignored):
        self.route = route
        self.segs: list[IndexSegment] = []
        self._rows: list[int] = []
        self.fold_rows = 0

    def push(self, seg: IndexSegment, *, n_rows: int | None = None) -> None:
        self.segs.append(seg)
        self._rows.append(seg.n_rows if n_rows is None else n_rows)

    def result(self) -> IndexSegment:
        if not self.segs:
            raise ValueError("no segments accumulated")
        if len(self.segs) == 1:
            return self.segs[0]
        self.fold_rows += sum(self._rows)
        segs, self.segs = self.segs, []
        merged = _merge_owned(segs, route=self.route)
        self.segs = [merged]
        self._rows = [merged.n_rows]
        return merged


class PairwiseSegmentAccumulator:
    """Fold every wave into one segment (O(waves x total)): the baseline, and
    the option with exactly one live segment at all times."""

    def __init__(self, *, route: str = "sort", **_ignored):
        self.route = route
        self._seg: IndexSegment | None = None
        self._rows = 0
        self.fold_rows = 0

    def push(self, seg: IndexSegment, *, n_rows: int | None = None) -> None:
        rows = seg.n_rows if n_rows is None else n_rows
        if self._seg is None:
            self._seg, self._rows = seg, rows
            return
        self.fold_rows += self._rows + rows
        prev, self._seg = self._seg, None
        self._seg = _merge_owned([prev, seg], route=self.route)
        self._rows = self._seg.n_rows

    def result(self) -> IndexSegment:
        if self._seg is None:
            raise ValueError("no segments accumulated")
        return self._seg


class GenerationalIndex:
    """L0..Ln immutable sorted segments + size-ratio compaction (an LSM tree).

    ``ingest`` freezes a job delta into a new L0 (newest-first list) and then
    compacts: while ``rows(L0) * size_ratio >= rows(L1)`` the two merge.  A
    level lives as a bare :class:`IndexSegment` until a reader touches it;
    :attr:`segments` then materializes its query artifact in place: flat for
    a fresh L0, compressed (with ``compress=True``) for a rung made by a
    merge.  ``generation`` bumps on every mutation -- the serving cache's
    invalidation key.  Runs on the card unless ``device`` says otherwise.
    Each level's row count is kept on the host (:attr:`level_rows`), so
    reading the stack's shape never waits on the device.

    ``route`` defaults to ``"merge"``, where ``repro`` defaults to ``"kway"``:
    the port's ``kway`` folds on the host, and a default index must keep its
    compactions on the card (every route gives the same segments).
    """

    def __init__(self, *, sigma: int, vocab_size: int, compress: bool = False,
                 block_size: int = 4, size_ratio: int = DEFAULT_SIZE_RATIO,
                 route: str = "merge", device=None):
        if size_ratio < 1:
            raise ValueError("size_ratio must be >= 1")
        self.device = resolve_device(device)
        self.sigma = sigma
        self.vocab_size = vocab_size
        self.compress = compress
        self.block_size = block_size
        self.size_ratio = size_ratio
        self.route = route
        self._next_id = 0
        self.levels = []
        self.generation = 0
        self.compaction_stats = {"ingests": 0, "merges": 0, "rows_merged": 0}

    # --- structure --------------------------------------------------------- #

    @property
    def levels(self) -> list:
        """Live level entries, newest first.  Assigning a list replaces the
        stack; its entries carry no merge provenance, so bare segments among
        them materialize flat."""
        return self._levels

    @levels.setter
    def levels(self, entries) -> None:
        self._levels = list(entries)
        self._from_merge = [False] * len(self._levels)
        self._level_ids = [self._take_id() for _ in self._levels]
        self._rows = [ix.n_rows for ix in self._levels]

    @property
    def level_ids(self) -> tuple:
        """Stable per-level identity tokens (newest first): a level keeps its
        id while its content is untouched; every ingest and merge mints one."""
        return tuple(self._level_ids)

    @property
    def level_rows(self) -> tuple:
        """Real rows of each level (newest first), held on the host."""
        return tuple(self._rows)

    def _take_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _materialize(self, i: int):
        """Build (and cache, replacing in place) level ``i``'s query artifact."""
        entry = self._levels[i]
        if isinstance(entry, IndexSegment):
            with obs_trace.span("gen.materialize") as sp:
                idx = index_from_segment(entry)
                # tier policy: merged (cold, grown) rungs freeze compressed,
                # fresh L0 deltas stay flat
                compressed = self.compress and self._from_merge[i]
                if compressed:
                    idx = compress_index(idx, block_size=self.block_size,
                                         device=self.device)
                if sp:
                    sp.set(level=i, rows=idx.n_rows, compressed=int(compressed))
            self._levels[i] = entry = idx
        return entry

    @property
    def segments(self) -> tuple:
        return tuple(self._materialize(i) for i in range(len(self._levels)))

    @property
    def n_segments(self) -> int:
        return len(self.levels)

    @property
    def n_rows(self) -> int:
        return sum(self._rows)

    @property
    def nbytes(self) -> int:
        return sum(ix.nbytes for ix in self.levels)

    @property
    def nbytes_at_rest(self) -> int:
        """Bytes of each level as it stands: compressed rungs their persisted
        streams, flat levels (and bare segments) their resident arrays."""
        return sum(getattr(ix, "nbytes_at_rest", ix.nbytes) for ix in self.levels)

    def __repr__(self) -> str:
        rows = "+".join(str(r) for r in self._rows) or "0"
        return (f"GenerationalIndex(gen={self.generation}, "
                f"segments={self.n_segments}, rows={rows})")

    # --- mutation ---------------------------------------------------------- #

    def ingest(self, stats: NGramStats) -> dict:
        """Freeze a job delta into L0, then compact.  Returns a report dict
        (rows ingested, merges performed, live segment row counts)."""
        if int(stats.grams.shape[1]) != self.sigma:
            raise ValueError(
                f"delta sigma {int(stats.grams.shape[1])} != index sigma "
                f"{self.sigma}")
        with obs_trace.span("gen.ingest") as sp:
            seg = None
            if len(stats):
                with obs_trace.span("gen.freeze"):
                    seg = segment_from_stats(stats, vocab_size=self.vocab_size,
                                             device=self.device)
            return self._ingest_body(seg, len(stats), sp)

    def ingest_segment(self, seg: IndexSegment | None, *,
                       n_rows: int | None = None) -> dict:
        """Ingest an already-frozen sorted segment as the new L0, then compact."""
        if seg is not None and (seg.sigma, seg.vocab_size) != (
                self.sigma, self.vocab_size):
            raise ValueError(
                f"segment meta ({seg.sigma}, {seg.vocab_size}) != index "
                f"({self.sigma}, {self.vocab_size})")
        with obs_trace.span("gen.ingest") as sp:
            rows = 0 if seg is None else \
                (seg.n_rows if n_rows is None else n_rows)
            return self._ingest_body(seg, rows, sp)

    def _ingest_body(self, seg, rows: int, sp) -> dict:
        """L0 insert + compaction + accounting.  An empty delta bumps the
        generation but inserts no segment."""
        merges = 0
        if rows:
            self._levels.insert(0, seg)
            self._from_merge.insert(0, False)       # fresh delta: hot, flat
            self._level_ids.insert(0, self._take_id())
            self._rows.insert(0, rows)
            merges = self._compact()
        self.generation += 1
        self.compaction_stats["ingests"] += 1
        self._publish_metrics()
        if sp:
            sp.set(rows=rows, merges=merges, segments=len(self.levels))
        return {"ingested_rows": rows, "merges": merges,
                "segment_rows": list(self._rows)}

    def _merge_front(self, n: int) -> None:
        # elder segments first: merge-path ties keep generation order
        with obs_trace.span("gen.compact") as sp:
            rows_in = sum(self._rows[:n])
            merged = merge_segments(
                [_merge_input_segment(e, route=self.route)
                 for e in reversed(self._levels[:n])],
                route=self.route,
                n_compressed=sum(isinstance(e, CompressedNGramIndex)
                                 for e in self._levels[:n]))
            self._levels[:n] = [merged]
            self._from_merge[:n] = [True]           # merged: cold at rest
            self._level_ids[:n] = [self._take_id()]
            self._rows[:n] = [merged.n_rows]
            self.compaction_stats["merges"] += 1
            self.compaction_stats["rows_merged"] += rows_in
            if sp:
                sp.set(rows_in=rows_in, rows_out=merged.n_rows)

    def _compact(self) -> int:
        merges = 0
        while (len(self._rows) >= 2 and
               self._rows[0] * self.size_ratio >= self._rows[1]):
            self._merge_front(2)
            merges += 1
        return merges

    def _publish_metrics(self) -> None:
        """Push live structure + lifetime compaction stats to the registry.

        A no-op (shared null singleton) when metrics are disabled; gauges
        carry the current shape (rung sizes newest first), counters mirror
        the monotonic ``compaction_stats``.  ``bytes_at_rest`` reads each
        entry as it stands: a bare (not yet materialized) rung reports its
        segment's bytes and shrinks at the first publish after its lazy
        compression; a compressed rung reports its persisted streams
        (``nbytes_at_rest``), not the resident total with its query state.
        """
        reg = obs_metrics.get_registry()
        if not reg:
            return
        reg.gauge("gen.generation").set(self.generation)
        reg.gauge("gen.segments").set(self.n_segments)
        reg.gauge("gen.rows").set(self.n_rows)
        n_comp, total_bytes = 0, 0
        for i, (ix, rows) in enumerate(zip(self._levels, self._rows)):
            reg.gauge(f"gen.rung{i}_rows").set(rows)
            b = getattr(ix, "nbytes_at_rest", None) or ix.nbytes
            total_bytes += b
            reg.gauge(f"gen.rung{i}_bytes_at_rest").set(b)
            n_comp += isinstance(ix, CompressedNGramIndex)
        reg.gauge("gen.bytes_at_rest").set(total_bytes)
        reg.gauge("gen.compressed_segments").set(n_comp)
        for k, v in self.compaction_stats.items():
            c = reg.counter(f"gen.{k}")
            c.add(v - c.value)          # counters mirror the lifetime totals

    def compact_all(self) -> None:
        """Force-merge every live segment into one (maintenance)."""
        if len(self.levels) >= 2:
            self._merge_front(len(self.levels))
            self.generation += 1
            self._publish_metrics()


def generational_from_stats(stats: NGramStats, *, vocab_size: int,
                            compress: bool = False, **kw) -> GenerationalIndex:
    """Bootstrap a generational index from one finished job's output."""
    gen = GenerationalIndex(sigma=int(stats.grams.shape[1]),
                            vocab_size=vocab_size, compress=compress, **kw)
    gen.ingest(stats)
    return gen
