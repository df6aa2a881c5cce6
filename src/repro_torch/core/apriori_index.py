"""APRIORI-INDEX (Algorithm 3): incremental inverted index with posting-list
joins (port of the single-device parts of ``repro.core.apriori_index``).

Phase 1 (k <= K): count the k-grams at every position directly.  Phase 2
(k > K): a frequent k-gram occurrence at position p exists only if frequent
(k-1)-gram occurrences exist at p *and* p + 1 -- the paper's Reducer-#2 join
of the posting lists of the two constituent (k-1)-grams.  The join runs on
the index, never rescanning the corpus for candidates.

Posting lists become a boolean occurrence mask over token positions, and the
join a shifted AND of masks plus an exact re-count of the surviving grams.
The reducer scatters each run's total back to every position of the run
(``reduce_exact`` with positions): the "posting list with frequencies" of
the paper.

On a mesh of P > 1 ranks positions are sharded contiguously, so the p + 1
join is local except for one boundary element, which the next rank sends
(a second halo, of its first occurrence flag).  Records carry global
positions; each reducer scatters its run totals into a dense [P * n_local]
vector and a reduce-scatter brings every rank the totals of its own
positions.  (``repro``'s ``shard_map`` job psums that vector and slices it,
the same function at P times the traffic, but its records carry positions
local to their shard: its joined rounds, k > K, lose occurrences, which
the port does not reproduce -- ``ROADMAP.md`` Queue 3.)
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import mesh_size
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle
from repro_torch.pipeline import plan as plan_mod
from .common import (count_exact_grams, gather_stats, gram_hash, halo,
                     kgram_records, pair_capacity, run_single_device,
                     shard_with_halo)
from .stats import NGramConfig, NGramStats, add_counters

__all__ = ["plan", "run"]


def _join_mask(cfg: NGramConfig, k: int, occ):
    """Phase-2 posting-list join: a k-gram occurs at p only if frequent
    (k-1)-grams occur at p and p+1; phase 1 (k <= K) has no precondition."""
    if k <= min(cfg.apriori_index_k, cfg.sigma) or occ is None:
        return None
    nxt = torch.cat([occ[1:], occ.new_zeros(1)])
    return occ & nxt


def _plan_emit(tok_ext, aux_ext, n_live, cfg: NGramConfig, carry, k):
    """Round-k map emit: k-grams at positions allowed by the occurrence mask.

    ``window_valid`` (the join-passing positions of the whole window, before
    the live mask) rides along for the ``tau_eff == 1`` carry.
    """
    if aux_ext is not None:
        raise NotImplementedError("bucket ids (time series) belong to "
                                  "SUFFIX-sigma alone, as in repro")
    records, valid = kgram_records(tok_ext, k, cfg.sigma, cfg.vocab_size,
                                   weight_mask=_join_mask(cfg, k, carry),
                                   with_positions=True)
    live_valid = valid
    if n_live < records.shape[0]:
        live_valid = valid & (torch.arange(records.shape[0],
                                           device=records.device) < n_live)
        # mask lanes and weight but KEEP the position lane: zeroed positions
        # would collide every invalid row onto index 0 in the reducer's
        # scatter of run totals, whose duplicate-index winner is unspecified
        records[:, :-1] *= live_valid[:, None]
    return records, live_valid, {"window_valid": valid}


def _update_carry(cfg: NGramConfig, tau_eff, k, tok_ext, stats_k,
                  reduce_extras, emit_extras, carry):
    """Occurrence mask of frequent k-grams for the next round's join.

    ``tau_eff == 1``: "frequent" means "occurs", which the emit already knows
    for every window position.  Otherwise the paper's rule: positions whose
    gram's collection frequency reaches tau (the reducer's run totals
    scattered back to positions), on the device.
    """
    if tau_eff == 1:
        return emit_extras["window_valid"]
    return reduce_extras["totals_pos"] >= tau_eff


def plan(cfg: NGramConfig) -> plan_mod.JobPlan:
    """APRIORI-INDEX as a :class:`JobPlan`: sigma chained jobs, occurrence-mask
    carry (the posting-list join), exact counting with position payloads."""
    return plan_mod.JobPlan(
        name="apriori_index",
        map=plan_mod.MapStage(_plan_emit, n_meta=1),
        shuffle=plan_mod.ShuffleStage("gram"),
        sort=plan_mod.SortStage(),
        reduce=plan_mod.ReduceStage("exact", with_positions=True),
        rounds=cfg.sigma,
        stop_on_empty=True,
        update_carry=_update_carry,
    )


def _run_distributed(tokens, cfg: NGramConfig, mesh, device) -> NGramStats:
    """APRIORI-INDEX across the ranks of ``mesh``: one distributed job a
    round (every rank calls it with the same arguments and gets the same
    output).  Counters as ``repro``'s: summed over the rounds, with no
    ``capacity`` or ``retries``."""
    n_l = packing.n_lanes(cfg.sigma, cfg.vocab_size)
    rec_bytes = packing.record_bytes(cfg.sigma, cfg.vocab_size, n_meta=1)
    tok_ext, n_local = shard_with_halo(tokens, cfg.sigma, mesh, device)
    n_ext = tok_ext.shape[0]
    k_join = min(cfg.apriori_index_k, cfg.sigma)
    counters = {"jobs": 0, "map_records": 0, "shuffle_records": 0,
                "shuffle_bytes": 0, "overflow": 0}
    out = None
    occ = None
    for k in range(1, cfg.sigma + 1):
        carry = None
        if k > k_join:
            # the window's occurrence flags: this rank's, then the next
            # rank's first (the join at the last position), zero past it
            nxt = halo(occ[:1].to(torch.uint8), mesh).bool()
            carry = torch.cat([occ, nxt, occ.new_zeros(max(0, n_ext - n_local - 1))]
                              )[:n_ext]
        records, valid, _ = _plan_emit(tok_ext, None, n_local, cfg, carry, k)
        records[:, n_l + 1] += mesh.rank * n_local          # global positions
        local, _, _ = shuffle.shuffle(
            records, gram_hash(records[:, :n_l]), valid, mesh=mesh,
            capacity=pair_capacity(cfg, n_local, mesh))
        (n_rec,) = mesh.sum_ints(valid.sum())
        del records, valid
        terms, flags, counts, totals = count_exact_grams(
            local, sigma=cfg.sigma, vocab_size=cfg.vocab_size, with_positions=True,
            n_positions=mesh.size * n_local)
        del local
        occ = mesh.reduce_scatter(totals) >= cfg.tau
        del totals
        st = gather_stats((terms, flags, counts), cfg.tau, mesh)
        add_counters(counters, jobs=1, map_records=n_rec, shuffle_records=n_rec,
                     shuffle_bytes=n_rec * rec_bytes)
        out = st if out is None else out.merged_with(st)
        if len(st) == 0:
            break
    out.counters = counters
    return out


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run an APRIORI-INDEX job.  ``tokens``: 1-D, PAD(0)-separated documents;
    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of P > 1 ranks
    runs the distributed rounds.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    if mesh_size(mesh) > 1:
        return _run_distributed(tokens, cfg, mesh, resolve_device(device))
    return run_single_device(tokens, cfg, plan(cfg), device=device)
