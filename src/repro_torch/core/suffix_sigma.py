"""SUFFIX-sigma (Algorithm 4 of the paper) as a single-device PyTorch job
(port of the non-mesh parts of ``repro.core.suffix_sigma``).

Phases (one MapReduce job, like the paper):

  map      -- per token position emit the sigma-truncated suffix as packed
              lanes with weight 1, and its time-series bucket when the job
              counts series (the ``suffix_pack`` kernel); an optional
              map-side combine merges equal suffixes (of one bucket).
  shuffle  -- partition by hash(first term); on one device the partition
              histogram (the ``hash_partition`` kernel) feeds ``shuffle_skew``.
  sort     -- lexicographic multi-key sort of the packed lanes.
  reduce   -- LCP boundaries between adjacent sorted suffixes delimit the runs
              of every distinct prefix (the ``lcp_boundary`` kernel); run
              totals are segmented sums of the weights, per bucket with
              ``NGramConfig.n_buckets`` (SSVI-B).

``sigma_split`` runs a large-sigma job in two phases: a SUFFIX-sigma job at
a short head length, then the longer grams from the positions whose head is
frequent.

On a mesh of P > 1 ranks (``run(mesh=)``) each rank maps its own row of
the ``[P, n_local]`` split plus a sigma - 1 token halo from the next rank,
combines, and shuffles by hash(lead term) through a fixed-capacity
``all_to_all`` (doubled while a pair overflows); each rank then sorts and
reduces what it received, and the ranks' outputs merge in rank order, as
``repro``'s ``shard_map`` job.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device, u32_words
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import suffix_windows
from repro_torch.launch.mesh import mesh_size
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle
from repro_torch.mapreduce.shuffle import GOLDEN, hash_u32
from repro_torch.pipeline import plan as plan_mod
from repro_torch.pipeline import stages
from .common import (as_tokens, gather_stats, gram_hash, member,
                     membership_hashes, pair_capacity, run_single_device,
                     shard_rows, shard_with_halo, term_present)
from .stats import NGramConfig, NGramStats, add_counters

__all__ = ["suffix_windows", "make_records", "reduce_block", "plan", "run",
           "sigma_split", "distributed_block"]


def make_records(tokens: torch.Tensor, *, sigma: int, vocab_size: int,
                 bucket_ids: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map emit: [N, n_lanes + 1 (+ 1)] int64 records = packed lanes | weight
    | (bucket), and the valid mask [N].

    The ``suffix_pack`` kernel writes whole records, weight and bucket
    included, in one pass: no lane matrix to copy, and no column written
    apart (a column alone fills a part of each 32-byte memory sector, which
    costs the card a read of the rest).  ``bucket_ids``: an int32 [N] tensor
    of uint32 words on the tokens' device (``repro_torch.u32_words``).
    """
    n_l = packing.n_lanes(sigma, vocab_size)
    width = n_l + 1 + (bucket_ids is not None)
    records = torch.empty((tokens.shape[0], width), dtype=torch.int64,
                          device=tokens.device)
    kops.suffix_pack(tokens, sigma=sigma, vocab_size=vocab_size, out=records,
                     meta=bucket_ids)
    return records, tokens != 0


def reduce_block(records: torch.Tensor, *, sigma: int, vocab_size: int,
                 n_buckets: int = 0):
    """Sort + count one reducer block: ``stages.sort_stage`` then
    ``stages.reduce_suffix``.

    records: [N, W] = lanes | weight | (bucket).  Returns (terms [N, sigma],
    flags [N, sigma], counts [N, sigma] or [N, sigma, B]).
    """
    rec = stages.sort_stage(records, n_keys=packing.n_lanes(sigma, vocab_size))
    return stages.reduce_suffix(rec, sigma=sigma, vocab_size=vocab_size,
                                n_buckets=n_buckets)


def _plan_emit(tok_ext, aux_ext, n_live, cfg: NGramConfig, carry, k):
    """Map emit over one token window; positions >= n_live carry no weight."""
    if cfg.n_buckets and aux_ext is None:
        raise ValueError("n_buckets > 0 counts per bucket: pass bucket_ids")
    records, valid = make_records(tok_ext, sigma=cfg.sigma,
                                  vocab_size=cfg.lane_vocab, bucket_ids=aux_ext)
    if n_live < records.shape[0]:
        pos_ok = torch.arange(records.shape[0], device=records.device) < n_live
        records = records * pos_ok[:, None]
        valid = valid & pos_ok
    return records, valid, {}


def plan(cfg: NGramConfig) -> plan_mod.JobPlan:
    """SUFFIX-sigma as a :class:`JobPlan`: one job, suffix emit, optional
    combiner, lead-term partitioning, LCP-run reducer."""
    return plan_mod.JobPlan(
        name="suffix_sigma",
        map=plan_mod.MapStage(_plan_emit),
        combine=plan_mod.CombineStage(cfg.combine_route) if cfg.combine else None,
        shuffle=plan_mod.ShuffleStage("lead"),
        sort=plan_mod.SortStage(),
        reduce=plan_mod.ReduceStage("suffix"),
        lane_vocab=cfg.lane_vocab,
    )


def _distributed(tokens, cfg: NGramConfig, mesh, device, bucket_ids=None
                 ) -> NGramStats:
    """One SUFFIX-sigma job across the ranks of ``mesh`` (every rank calls
    it with the same arguments and gets the same output)."""
    n_l = packing.n_lanes(cfg.sigma, cfg.lane_vocab)
    tok_ext, n_local = shard_with_halo(tokens, cfg.sigma, mesh, device)
    aux = None
    if bucket_ids is not None:
        own, _ = shard_rows(bucket_ids, mesh)
        aux = torch.cat([u32_words(own, device),
                         torch.zeros(tok_ext.shape[0] - n_local, dtype=torch.int32,
                                     device=device)])
    records, valid, _ = _plan_emit(tok_ext, aux, n_local, cfg, None, 1)
    map_rec = valid.sum()
    if cfg.combine:
        records = stages.combine(records, n_l, aux is not None,
                                 route=cfg.combine_route)
    lead = packing.lead_term(records[:, 0], vocab_size=cfg.lane_vocab)
    local, capacity, retries = shuffle.shuffle(
        records, lead, records[:, n_l] > 0, mesh=mesh,
        capacity=pair_capacity(cfg, n_local, mesh))
    del records, valid, lead
    map_rec, shuf_rec = mesh.sum_ints(map_rec, (local[:, n_l] > 0).sum())
    dense = reduce_block(local, sigma=cfg.sigma, vocab_size=cfg.lane_vocab,
                         n_buckets=cfg.n_buckets)
    del local
    rec_bytes = packing.record_bytes(cfg.sigma, cfg.lane_vocab,
                                     n_meta=1 if aux is not None else 0)
    return gather_stats(dense, cfg.tau, mesh, {
        "map_records": map_rec, "shuffle_records": shuf_rec,
        "shuffle_bytes": shuf_rec * rec_bytes, "jobs": 1, "overflow": 0,
        "capacity": capacity, "retries": retries})


def distributed_block(tok: torch.Tensor, cfg: NGramConfig, mesh, capacity: int):
    """One rank's part of the job at a fixed ``capacity``: the body of
    ``repro``'s ``build_distributed_job``, every shape fixed by its
    arguments.  ``tok`` is this rank's row [n_local]; ``mesh`` a
    ``launch.mesh.MeshAxes`` (the dry run's flat mesh of reducers).

    The halo comes from the next rank by a permute; the records are
    emitted, combined and bucketed at ``capacity`` (the part past it
    counted as overflow, not fitted as :func:`run` does), exchanged, sorted
    and reduced.  Returns (terms [P * capacity, sigma], flags, counts,
    stats [3]: the map records, the shuffled records and the records past
    the capacity, each summed over the ranks), as ``repro``'s job does a
    row."""
    n_l = packing.n_lanes(cfg.sigma, cfg.lane_vocab)
    n_local, p = tok.shape[0], mesh.size
    if cfg.sigma > 1:
        halo = mesh.permute(tok[: cfg.sigma - 1], [(i - 1) % p for i in range(p)])
        if mesh.rank == p - 1:
            halo = torch.zeros_like(halo)
        tok = torch.cat([tok, halo])
    records, valid, _ = _plan_emit(tok, None, n_local, cfg, None, 1)
    map_rec = valid.sum()
    if cfg.combine:
        records = stages.combine(records, n_l, False, route=cfg.combine_route)
    lead = packing.lead_term(records[:, 0], vocab_size=cfg.lane_vocab)
    part, hist = kops.hash_partition(lead, records[:, n_l] > 0, n_parts=p)
    buf, overflow = shuffle.bucketize(records, part, p, capacity, counts=hist)
    del records, valid, lead, part
    local = shuffle.exchange(buf, mesh)
    del buf
    stats = mesh.all_reduce(torch.stack([map_rec, (local[:, n_l] > 0).sum(), overflow]))
    terms, flags, counts = reduce_block(local, sigma=cfg.sigma, vocab_size=cfg.lane_vocab,
                                        n_buckets=cfg.n_buckets)
    return terms, flags, counts, stats


def run(tokens, cfg: NGramConfig, mesh=None, *, bucket_ids=None,
        device=None) -> NGramStats:
    """Run a SUFFIX-sigma job.  ``tokens``: 1-D, PAD(0)-separated documents;
    ``bucket_ids``: one time-series bucket a position (read as uint32), which
    ``cfg.n_buckets > 0`` counts per bucket (``NGramStats.to_series_dict``).
    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of P > 1 ranks
    runs the distributed job (counters as ``repro``'s: ``capacity`` and
    ``retries`` of the shuffle, no ``shuffle_skew``).

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    if mesh_size(mesh) > 1:
        return _distributed(tokens, cfg, mesh, resolve_device(device), bucket_ids)
    return run_single_device(tokens, cfg, plan(cfg), device=device,
                             bucket_ids=bucket_ids)


# --------------------------------------------------------- two-phase sigma split
def _head_hash(head_lanes: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """``gram_hash`` of head grams packed at the full job's ``n_lanes``
    lanes, from their first lanes alone: the lanes past the head are zero,
    and the fold of a zero lane is ``hash_u32(h ^ GOLDEN)``."""
    h = gram_hash(head_lanes)
    for _ in range(n_lanes - head_lanes.shape[1]):
        h = hash_u32(h ^ GOLDEN)
    return h


def sigma_split(tokens, cfg: NGramConfig, sigma_head: int = 16,
                survivor_frac: float = 1 / 64, *, device=None) -> NGramStats:
    """A large-sigma job in two phases (``repro``'s beyond-paper
    optimization, exact):

      phase A: SUFFIX-sigma at ``sigma_head`` counts every gram of length
               <= sigma_head, with (sigma_head + 1)-lane records;
      phase B: only the positions whose length-``sigma_head`` head gram is
               frequent (APRIORI: every occurrence of a frequent longer gram
               passes) emit full sigma-truncated suffixes, which count the
               lengths in (sigma_head, sigma].

    The head dictionary is ``common.membership_hashes`` of phase A's
    full-length grams; a position's head hash comes from its
    ``suffix_pack`` lanes at ``sigma_head``.  Survivor positions are
    compacted before the wide records are built, into a buffer of
    ``max(64, N * survivor_frac)`` rows; when more positions survive, the
    fraction grows 4x until they fit (``repro`` reruns the whole split; its
    counters are those of the run that fits, so the result is the same).
    Counters: phase A's, plus ``phase_b_records`` (the survivors) and
    ``phase_b_overflow`` (survivors past the buffer: 0 in the result).
    Runs on the card unless ``device`` says otherwise.
    """
    tokens = as_tokens(tokens, device)
    if sigma_head >= cfg.sigma:
        return run(tokens, cfg, device=tokens.device)
    stats_a = run(tokens, dataclasses.replace(cfg, sigma=sigma_head),
                  device=tokens.device)
    heads = stats_a.grams[stats_a.lengths == sigma_head]
    if heads.shape[0] == 0:
        return stats_a

    vocab, n, dev = cfg.vocab_size, tokens.shape[0], tokens.device
    n_wide = packing.n_lanes(cfg.sigma, vocab)
    head_pad = torch.zeros((heads.shape[0], cfg.sigma), dtype=torch.int32, device=dev)
    head_pad[:, :sigma_head] = torch.as_tensor(heads[:, :sigma_head], device=dev)
    dict_hashes = membership_hashes(packing.pack_terms(head_pad, vocab_size=vocab),
                                    torch.ones(heads.shape[0], dtype=torch.bool,
                                               device=dev))

    # phase B: positions whose full head is in the dictionary
    head_lanes = kops.suffix_pack(tokens, sigma=sigma_head, vocab_size=vocab)
    eligible = ((tokens != 0) & term_present(head_lanes, sigma_head, vocab, sigma_head - 1)
                & member(dict_hashes, _head_hash(head_lanes, n_wide)))
    del head_lanes
    n_eligible = int(eligible.sum())
    n_b = max(64, int(n * survivor_frac))
    while n_eligible > n_b:                     # survivor buffer too small
        survivor_frac = min(1.0, survivor_frac * 4)
        n_b = max(64, int(n * survivor_frac))

    # the wide records of the survivors alone, in a buffer of n_b rows
    pos = eligible.nonzero().squeeze(1)
    del eligible
    padded = torch.cat([tokens, tokens.new_zeros(cfg.sigma)])
    win = padded[pos[:, None] + torch.arange(cfg.sigma, device=dev)[None, :]]
    win *= torch.cumprod(win != 0, dim=1, dtype=torch.int32)
    records = torch.zeros((min(n_b, n), n_wide + 1), dtype=torch.int64, device=dev)
    records[:n_eligible, :n_wide] = packing.pack_terms(win, vocab_size=vocab)
    records[:n_eligible, n_wide] = 1
    del win, padded, pos
    terms, flags, counts = reduce_block(records, sigma=cfg.sigma, vocab_size=vocab)
    flags[:, :sigma_head] = False               # phase A owns lengths <= sigma_head
    from repro_torch.pipeline.executor import materialize
    stats_b = materialize((terms, flags, counts), cfg.tau)

    stats_a = NGramStats(
        np.pad(stats_a.grams, ((0, 0), (0, cfg.sigma - sigma_head))),
        stats_a.lengths, stats_a.counts, stats_a.counters)
    out = stats_a.merged_with(stats_b)
    add_counters(out.counters, phase_b_records=n_eligible, phase_b_overflow=0)
    return out
