"""Sharded query serving across ranks, and the serving-side index description
(port of ``repro.index.serve``).

The job-side shuffle routes *records* to reducers by hash(lead term)
(``mapreduce.shuffle``, the paper's Algorithm-4 partitioner).  Serving routes
*queries* the same way: :func:`build_sharded_index` partitions the frozen
index rows with the identical hash, so rank p holds exactly the grams
reducer p would have emitted, every query's answer lives on one known rank,
and -- since all continuations of a prefix share its lead term -- top-k
completion queries route as point lookups do.

One serving step on a :class:`~repro_torch.launch.mesh.DataMesh` is the
dispatch pattern inverted.  Every rank holds the whole batch and takes its
own ``ceil(B / P)`` rows, then:

  partition  queries by hash(lead term)          (the ``hash_partition`` kernel)
  bucketize  into the [P, capacity, W] buffer    (shuffle.bucketize)
  all_to_all queries to their owning rank        (shuffle.exchange)
  answer     locally (index/query.py: ``bsearch``, or ``block_decode`` on a
             compressed shard)
  all_to_all results back along the same route
  scatter    results to each query's original slot (carried as a meta lane)
  gather     every rank's rows, so each rank returns the whole batch's answers

Capacity is the job shuffle's head-room knob: a batch whose busiest
(source, destination) pair overflows runs at doubled capacity, counted in
``serve.retries``.  Length-0 continuation prefixes (top-k unigrams) have no
lead term to route by: each rank's local top-k is gathered and merged, once
per (index, k).

:func:`describe_topology` reports how queries route to data, for the
frontend's ``/v1/system/topology``.  Its numbers are read on the host: row
counts from the generational index's host ledger
(:attr:`GenerationalIndex.level_rows`) and bytes from tensor shapes (the
sharded index's from its build), so a transport thread that asks never waits
on the device.  A generational level no query has read yet therefore reports
its bare segment's bytes, where ``repro`` would build the artifact first.

:func:`shard_generational` partitions every live segment of a
:class:`GenerationalIndex` the same way, one :class:`ShardedNGramIndex` a
segment (a :class:`ShardedGenerationalIndex`), reusing the shards of an
earlier generation's levels by level id; :func:`serve` sums its segments'
lookups and folds their continuation sets exactly, as the single-device
generational index does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import U32
from repro_torch.core.stats import NGramStats
from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from . import query as q
from .build import NGramIndex, build_index
from .compress import CompressedNGramIndex, compress_index
from .merge import GenerationalIndex, merge_continuation_results, segment_to_stats

__all__ = ["ShardedNGramIndex", "ShardedGenerationalIndex", "shard_of_rows",
           "build_sharded_index", "result_width", "make_server",
           "empty_prefix_continuations", "serve", "shard_generational",
           "describe_topology"]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedNGramIndex:
    """This rank's shard of an index partitioned by hash(lead term).

    ``index`` is the shard (flat or compressed), padded to the common
    capacity; ``nbytes`` counts every rank's shard, as ``repro``'s stacked
    ``[P, ...]`` index counts them.
    """

    index: NGramIndex | CompressedNGramIndex
    mesh: object
    nbytes: int
    # the empty-prefix answer a k, computed once (it is a function of the
    # index and k) and dropped with the index
    _empty: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_parts(self) -> int:
        return self.mesh.size

    @property
    def axis_name(self) -> str:
        return self.mesh.axis_name

    @property
    def sigma(self) -> int:
        return self.index.sigma


def shard_of_rows(first_terms, n_parts: int) -> np.ndarray:
    """Owning shard per gram row -- the job shuffle's partitioner."""
    t = torch.as_tensor(np.asarray(first_terms, np.int64))
    return (shuffle.hash_u32(t) % n_parts).numpy()


def build_sharded_index(stats: NGramStats, *, vocab_size: int, mesh,
                        compress: bool = False, block_size: int = 4,
                        device=None) -> ShardedNGramIndex:
    """Partition ``stats`` rows by hash(lead term) and freeze this rank's
    part into its shard (every rank calls it with the same ``stats``).

    Shards are padded to one capacity, ``max(128, ceil((largest + 1) / 128)
    * 128)`` rows.  ``compress=True`` re-encodes each shard into the
    front-coded + Elias-Fano layout against the maxima over the ranks of
    its stream sizes and widths, so every shard has the same shapes, as
    ``repro``'s stacked shards must.  Builds on the card unless ``device``
    says otherwise.
    """
    grams = np.asarray(stats.grams)
    part = shard_of_rows(grams[:, 0] if len(stats) else np.zeros(0, np.int64),
                         mesh.size)
    rows = np.bincount(part, minlength=mesh.size)
    cap = max(128, -(-(int(rows.max()) + 1) // 128) * 128)
    mine = part == mesh.rank
    ix = build_index(NGramStats(grams[mine], stats.lengths[mine],
                                stats.counts[mine]),
                     vocab_size=vocab_size, pad_to=cap, device=device)
    if compress:
        probe = compress_index(ix, block_size=block_size, device=ix.device)
        top = mesh.all_reduce(torch.tensor(
            [probe.count_width, probe.payload.shape[0], probe.cont_payload.shape[0],
             probe.ef_cumsum.universe, probe.head_span], device=mesh.device), "max")
        cw, pw, cpw, universe, span = (int(v) for v in top.tolist())
        ix = compress_index(ix, block_size=block_size, count_width=cw,
                            payload_words=pw, cont_payload_words=cpw,
                            cumsum_universe=universe, head_span=span,
                            device=ix.device)
    (nbytes,) = mesh.sum_ints(ix.nbytes)
    return ShardedNGramIndex(ix, mesh, nbytes)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGenerationalIndex:
    """One :class:`ShardedNGramIndex` a live generational segment, newest
    first.  Segment sizes differ by design, so each keeps its own shard
    capacity, and the fold across segments runs after each segment's
    answers are back on every rank.  ``level_ids`` are the levels each
    shard was built from (``GenerationalIndex.level_ids``) and ``layout``
    the (compress, block_size) of the build: together the key under which
    :func:`shard_generational` reuses a shard."""

    shards: tuple
    generation: int
    mesh: object
    level_ids: tuple = ()
    layout: tuple = ()

    @property
    def n_segments(self) -> int:
        return len(self.shards)

    @property
    def n_parts(self) -> int:
        return self.mesh.size

    @property
    def axis_name(self) -> str:
        return self.mesh.axis_name

    @property
    def sigma(self) -> int:
        return self.shards[0].sigma

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)


def shard_generational(gen: GenerationalIndex, *, mesh, compress: bool | None = None,
                       block_size: int | None = None,
                       prev: ShardedGenerationalIndex | None = None
                       ) -> ShardedGenerationalIndex:
    """Partition every live segment of ``gen`` over the ranks of ``mesh``
    (every rank calls it with its own copy of the same index).

    Layout defaults to the index's own (``compress``, ``block_size``).  Empty
    segments are skipped when a non-empty one exists: a shard of nothing
    would cost every batch a routed round trip to add zeros.  ``prev``, a
    sharded index of an earlier generation of ``gen`` on the same mesh and
    layout, lends the shards of every level it shares by level id (levels
    are immutable), so only new and merged levels are partitioned, built
    and compressed.  Rank 0 counts ``serve.shard_builds`` and
    ``serve.shard_reuses``.  Shards live on the index's device.
    """
    if not gen.level_ids:
        raise ValueError("cannot shard an empty GenerationalIndex")
    compress = gen.compress if compress is None else compress
    block_size = gen.block_size if block_size is None else block_size
    layout = (bool(compress), int(block_size))
    cache: dict = {}
    if prev is not None and prev.mesh is mesh and prev.layout == layout:
        cache = dict(zip(prev.level_ids, prev.shards))
    ids, segments = gen.level_ids, gen.segments
    pairs = [(lid, ix) for lid, ix, rows in zip(ids, segments, gen.level_rows)
             if rows] or [(ids[0], segments[0])]
    reused = sum(lid in cache for lid, _ in pairs)
    leader = mesh.rank == 0
    with obs_trace.span("serve.shard_generational") if leader else obs_trace.NULL_SPAN as sp:
        if sp:
            sp.set(segments=len(pairs), reused=reused)
        shards = tuple(
            cache[lid] if lid in cache else
            build_sharded_index(segment_to_stats(ix.to_segment()),
                                vocab_size=gen.vocab_size, mesh=mesh,
                                compress=compress, block_size=block_size,
                                device=gen.device)
            for lid, ix in pairs)
    reg = obs_metrics.get_registry() if leader else obs_metrics.null_registry
    if reg:
        reg.counter("serve.shard_builds").add(len(pairs) - reused)
        reg.counter("serve.shard_reuses").add(reused)
    return ShardedGenerationalIndex(shards=shards, generation=gen.generation,
                                    mesh=mesh, level_ids=tuple(lid for lid, _ in pairs),
                                    layout=layout)


def describe_topology(index_like) -> dict:
    """JSON-able shard/segment map -- the frontend's ``/v1/system/topology``.

    A :class:`ShardedGenerationalIndex` (kind ``"sharded_generational"``)
    lists its segments' shards newest first by level id; a
    :class:`ShardedNGramIndex` (kind ``"sharded"``) publishes its
    partitioning: every query's answer lives on rank ``hash_u32(lead_term)
    % n_parts``, the job shuffle's own partitioner, so ``n_parts`` and the
    partitioner name are a complete routing contract for an external
    router.  A :class:`GenerationalIndex` (kind ``"generational"``) lists
    its segments newest first, with stable level ids so clients can diff
    generations; one flat or compressed index is kind ``"index"``.
    """
    if isinstance(index_like, ShardedGenerationalIndex):
        return {
            "kind": "sharded_generational",
            "generation": int(index_like.generation),
            "n_parts": int(index_like.n_parts),
            "axis": index_like.axis_name,
            "partitioner": "hash_u32(lead_term) % n_parts",
            "nbytes": int(index_like.nbytes),
            "segments": [{"level_id": int(lid), "nbytes": int(sh.nbytes)}
                         for lid, sh in zip(index_like.level_ids, index_like.shards)],
        }
    if isinstance(index_like, ShardedNGramIndex):
        return {
            "kind": "sharded",
            "n_parts": int(index_like.n_parts),
            "axis": index_like.axis_name,
            "partitioner": "hash_u32(lead_term) % n_parts",
            "nbytes": int(index_like.nbytes),
        }
    if isinstance(index_like, GenerationalIndex):
        levels = index_like.levels
        return {
            "kind": "generational",
            "generation": int(index_like.generation),
            "n_segments": int(index_like.n_segments),
            "n_rows": int(index_like.n_rows),
            "nbytes": int(index_like.nbytes),
            "compress": bool(index_like.compress),
            "segments": [{"level_id": int(lid), "rows": int(rows),
                          "nbytes": int(ix.nbytes)}
                         for lid, rows, ix in zip(index_like.level_ids,
                                                  index_like.level_rows, levels)],
        }
    # single frozen index (flat or compressed): one segment, no routing
    return {"kind": "index", "rows": int(index_like.n_rows),
            "nbytes": int(index_like.nbytes)}


def result_width(mode: str, k: int) -> int:
    """Result lanes a query: cf, or n_distinct | total | terms[k] | counts[k]."""
    return 1 if mode == "lookup" else 2 + 2 * k


def make_server(sharded: ShardedNGramIndex, *, mode: str = "lookup", k: int = 8,
                capacity_factor: float = 2.0, max_retries: int = 6):
    """One serving step: ``step(grams [b, sigma], lengths [b])`` -> (results
    [b, result_width] int64 of this rank's queries, capacity, retries), run
    by every rank together on its own rows.

    ``mode``: ``"lookup"`` (point cf) or ``"continuations"`` (top-k
    completion); the step needs length >= 1 either way (routing hashes the
    lead term): :func:`serve` answers length-0 prefixes apart.
    """
    if mode not in ("lookup", "continuations"):
        raise ValueError(f"unknown serve mode {mode!r}")
    idx, mesh = sharded.index, sharded.mesh
    n_parts, n_l, sigma = mesh.size, idx.n_lanes, idx.sigma
    r_out = result_width(mode, k)

    def step(grams: torch.Tensor, lengths: torch.Tensor):
        b_local = grams.shape[0]
        grams, lengths, valid = q._clean(idx, grams, lengths, lo_len=1)
        if mode == "continuations":
            valid &= lengths <= sigma - 1
        records = torch.cat([packing.pack_terms(grams, vocab_size=idx.vocab_size),
                             lengths.to(torch.int64)[:, None],
                             torch.arange(b_local, device=grams.device)[:, None],
                             valid.to(torch.int64)[:, None]], dim=1)
        part, hist = kops.hash_partition(grams[:, 0].to(torch.int64), valid,
                                         n_parts=n_parts)
        capacity = min(b_local, max(8, int(capacity_factor * b_local / n_parts) + 1))
        capacity, retries = shuffle.fit_capacity(hist, capacity, mesh,
                                                 max_retries=max_retries,
                                                 what="query shuffle")
        buf, _ = shuffle.bucketize(records, part, n_parts, capacity, counts=hist)
        slot_map = buf[:, :, n_l + 1].reshape(-1)     # send-side bookkeeping
        sent = buf[:, :, n_l + 2].reshape(-1) > 0
        remote = shuffle.exchange(buf, mesh)          # [P * cap, W] to answer
        r_lanes = remote[:, :n_l].contiguous()
        r_len = remote[:, n_l].to(torch.int32)
        r_valid = remote[:, n_l + 2] > 0
        if mode == "lookup":
            res = q.lookup_packed(idx, r_lanes, r_len, r_valid)[:, None]
        else:
            nd, tot, terms, counts = q.continuations_packed(
                idx, r_lanes, r_len, r_valid, k=k)
            res = torch.cat([nd[:, None], tot[:, None], terms, counts], dim=1)
        back = mesh.all_to_all(res.reshape(n_parts, capacity, r_out))
        out = torch.zeros((b_local + 1, r_out), dtype=torch.int64,
                          device=grams.device)
        out[torch.where(sent, slot_map, b_local)] = back.reshape(-1, r_out)
        return out[:b_local], capacity, retries

    return step


def empty_prefix_continuations(sharded: ShardedNGramIndex, *, k: int = 8
                               ) -> np.ndarray:
    """The merged empty-prefix (unigram top-k) answer [2 + 2k] int64.

    Every unigram lives on exactly one rank, so the cross-rank merge is
    exact: each rank's local top-k over its length-1 section is gathered,
    the disjoint distinct/mass totals summed, and the k best kept (the term
    id breaks count ties).  Any global top-k unigram is in its own rank's
    top-k, so k rows a rank suffice.  Every rank calls it together.
    """
    idx = sharded.index
    nd, tot, terms, counts = q.continuations(
        idx, torch.zeros((1, idx.sigma), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), k=k)
    mine = (int(nd[0]), int(tot[0]),
            [(int(c), int(t)) for t, c in zip(terms[0].tolist(), counts[0].tolist())
             if c > 0])
    parts = sharded.mesh.all_gather_object(mine)
    pairs = sorted((pair for _, _, ps in parts for pair in ps),
                   key=lambda ct: (-ct[0], ct[1]))
    out = np.zeros((2 + 2 * k,), np.int64)
    out[0] = sum(p[0] for p in parts)
    out[1] = sum(p[1] for p in parts)
    for i, (c, t) in enumerate(pairs[:k]):
        out[2 + i] = t
        out[2 + k + i] = c
    return out


def _serve_generational(sharded: ShardedGenerationalIndex, grams, lengths, *,
                        mode: str, k: int, **kw) -> np.ndarray:
    """Every segment's answers through :func:`serve`, folded: lookups
    summed (with ``repro``'s uint32 overflow error), continuations from each
    segment's complete candidate set (``query.generational_continuation_sets``)
    merged exactly (``merge.merge_continuation_results``).

    A first fetch at ``k`` gives every segment's exact number of distinct
    continuations of each query; a query whose every segment has at most
    ``k`` is complete there, and the others are fetched again in groups of
    one width, the power of two that holds their largest set.  So a batch
    moves each query's candidates at its own width, not at the widest
    query's (a common lead term has thousands), and the answers equal one
    fold of the whole batch: each query's fold reads only its own sets.
    """
    shards = sharded.shards
    if mode == "lookup":
        acc = np.zeros((len(lengths),), np.int64)
        for sh in shards:
            acc += serve(sh, grams, lengths, mode="lookup", **kw)
        if acc.size and int(acc.max()) > U32:
            raise ValueError(
                f"summed cf {int(acc.max())} across live segments overflows "
                "uint32; compact the index or raise tau")
        return acc
    grams = grams.cpu().numpy() if isinstance(grams, torch.Tensor) else np.asarray(grams)
    lengths = (lengths.cpu().numpy() if isinstance(lengths, torch.Tensor)
               else np.asarray(lengths))

    def fetcher(rows):
        def fetch(sh, m):
            res = _serve_on_device(sh, grams[rows], lengths[rows],
                                   mode="continuations", k=m, **kw)
            return res[:, 0], res[:, 1], res[:, 2:2 + m], res[:, 2 + m:]
        return fetch

    out = np.zeros((len(lengths), result_width("continuations", k)), np.int64)
    if not len(lengths):
        return out
    every = np.arange(len(lengths))
    first = [fetcher(every)(sh, k) for sh in shards]
    need = torch.stack([nd for nd, *_ in first]).max(dim=0).values.cpu().numpy()
    width = np.where(need <= k, k, 1 << np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64))
    for w in np.unique(width):
        rows = np.flatnonzero(width == w)
        if w == k:
            at = torch.as_tensor(rows, device=first[0][0].device)
            per = [tuple(x[at] for x in p) for p in first]
        else:
            per, _ = q.generational_continuation_sets(shards, fetcher(rows), k=int(w))
        nd, total, terms, counts = merge_continuation_results(per, k=k)
        out[rows] = torch.cat([nd[:, None], total[:, None], terms, counts],
                              dim=1).cpu().numpy()
    return out


def serve(sharded: ShardedNGramIndex | ShardedGenerationalIndex, grams, lengths, *,
          mode: str = "lookup", k: int = 8, capacity_factor: float = 2.0,
          max_retries: int = 6) -> np.ndarray:
    """Answer one query batch across the ranks, every rank with the same
    batch, doubling the capacity while a pair overflows.

    grams [B, sigma], lengths [B] (host or device).  Returns the int64
    host array of ``uint32`` answers of the whole batch, on every rank: [B]
    counts (``"lookup"``) or [B, 2 + 2k] continuation results (see
    :func:`result_width`).  ``capacity_factor``: the head-room knob, with
    ``min(b_local, max(8, factor * b_local / P + 1))`` rows a pair first
    (``b_local = ceil(B / P)``).  Length-0 continuation prefixes get the
    cached :func:`empty_prefix_continuations` answer.  Rank 0 records the
    ``serve.batch`` span and the ``serve.*`` instruments, as ``repro``'s
    single controller does.  A :class:`ShardedGenerationalIndex` is served
    a segment at a time, and the answers fold on every rank.
    """
    if isinstance(sharded, ShardedGenerationalIndex):
        return _serve_generational(sharded, grams, lengths, mode=mode, k=k,
                                   capacity_factor=capacity_factor,
                                   max_retries=max_retries)
    out = _serve_on_device(sharded, grams, lengths, mode=mode, k=k,
                           capacity_factor=capacity_factor,
                           max_retries=max_retries).cpu().numpy()
    return out[:, 0] if mode == "lookup" else out


def _serve_on_device(sharded: ShardedNGramIndex, grams, lengths, *, mode: str, k: int,
                     capacity_factor: float, max_retries: int) -> torch.Tensor:
    """:func:`serve` of one sharded index, its answers [B, result_width]
    left on the index's device."""
    mesh, idx = sharded.mesh, sharded.index
    grams = torch.as_tensor(np.asarray(grams) if not isinstance(grams, torch.Tensor)
                            else grams)
    lengths = torch.as_tensor(np.asarray(lengths) if not isinstance(lengths, torch.Tensor)
                              else lengths)
    b = grams.shape[0]
    b_local = -(-b // mesh.size)
    lo = min(mesh.rank * b_local, b)
    g = torch.zeros((b_local, grams.shape[1]), dtype=torch.int32, device=idx.device)
    ln = torch.zeros(b_local, dtype=torch.int32, device=idx.device)
    g[:max(0, min(b, lo + b_local) - lo)] = grams[lo:lo + b_local].to(idx.device)
    ln[:max(0, min(b, lo + b_local) - lo)] = lengths[lo:lo + b_local].to(idx.device)
    leader = mesh.rank == 0
    reg = obs_metrics.get_registry() if leader else obs_metrics.null_registry
    with obs_trace.span("serve.batch") if leader else obs_trace.NULL_SPAN as sp:
        if sp:
            sp.set(mode=mode, batch=b, parts=mesh.size)
        t0 = time.perf_counter()
        step = make_server(sharded, mode=mode, k=k, capacity_factor=capacity_factor,
                           max_retries=max_retries)
        mine, capacity, retries = step(g, ln)
        if sp:
            sp.set(retries=retries, capacity=capacity)
        if reg:
            reg.counter("serve.batches").add(1)
            reg.counter("serve.queries").add(b)
            reg.counter("serve.retries").add(retries)
            reg.histogram("serve.batch_seconds").observe(time.perf_counter() - t0)
    out = mesh.all_gather(mine).reshape(mesh.size * b_local, -1)[:b]
    if mode == "continuations":
        empty = (lengths == 0).to(out.device)
        if bool(empty.any()):
            if k not in sharded._empty:
                sharded._empty[k] = empty_prefix_continuations(sharded, k=k)
            out[empty] = torch.as_tensor(sharded._empty[k], device=out.device)
    return out
