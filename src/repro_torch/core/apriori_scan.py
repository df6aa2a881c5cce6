"""APRIORI-SCAN (Algorithm 2): one scan of the corpus per gram length (port of
the single-device parts of ``repro.core.apriori_scan``).

Job k emits only those k-grams whose two constituent (k-1)-grams were output
(frequent) by job k-1 -- candidate pruning by the APRIORI principle.  The
paper keeps the previous job's output in a per-node dictionary (distributed
cache / BerkeleyDB); here it is a sorted array of gram hashes probed by
binary search (``common.membership_hashes``).  A hash collision only admits
an extra candidate, which job k's exact count filters again.

Termination matches the paper: after sigma jobs or when a job outputs
nothing.  On a mesh of P > 1 ranks every round is a distributed job (halo,
whole-gram hash shuffle, exact count on each rank); every rank builds the
next dictionary from the round's merged output, so it is replicated with no
broadcast (the distributed cache of the paper).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import mesh_size
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle
from repro_torch.pipeline import plan as plan_mod
from .common import (count_exact_grams, gather_stats, gram_hash, kgram_records,
                     member, membership_hashes, pair_capacity, prefix_masks,
                     run_single_device, shard_with_halo, suffix_lanes)
from .stats import NGramConfig, NGramStats, add_counters

__all__ = ["plan", "run"]


def _candidates(tokens: torch.Tensor, k: int, cfg: NGramConfig,
                freq_hashes: torch.Tensor | None):
    """Candidate k-gram records at every position, pruned by the (k-1)
    dictionary: the (k-1)-grams at ``p`` and at ``p + 1`` must both be in it.
    Position ``p + 1`` of the last row wraps to row 0, as ``jnp.roll`` does
    in ``repro``; that row never holds a k-gram for k >= 2."""
    sigma, vocab = cfg.sigma, cfg.vocab_size
    lanes = suffix_lanes(tokens, sigma, vocab)
    if k == 1 or freq_hashes is None:
        return kgram_records(tokens, k, sigma, vocab, lanes=lanes)
    km1 = prefix_masks(sigma, vocab, lanes.device)[k - 1]
    pref_ok = member(freq_hashes, gram_hash(lanes & km1))
    suff_ok = member(freq_hashes, gram_hash(torch.roll(lanes, -1, dims=0) & km1))
    return kgram_records(tokens, k, sigma, vocab, weight_mask=pref_ok & suff_ok,
                         lanes=lanes)


def _plan_emit(tok_ext, aux_ext, n_live, cfg: NGramConfig, carry, k):
    """Round-k map emit: candidate k-grams pruned by the (k-1) dictionary.

    The records and valid mask of the whole window, before the live mask,
    ride along in ``emit_extras`` for the ``tau_eff == 1`` carry.
    """
    if aux_ext is not None:
        raise NotImplementedError("bucket ids (time series) belong to "
                                  "SUFFIX-sigma alone, as in repro")
    records, valid = _candidates(tok_ext, k, cfg, carry)
    live_records, live_valid = records, valid
    if n_live < records.shape[0]:
        pos_ok = torch.arange(records.shape[0], device=records.device) < n_live
        live_valid = valid & pos_ok
        live_records = records * live_valid[:, None]
    return live_records, live_valid, {"window_records": records,
                                      "window_valid": valid}


def _update_carry(cfg: NGramConfig, tau_eff, k, tok_ext, stats_k,
                  reduce_extras, emit_extras, carry):
    """Next round's dictionary (the Hadoop distributed-cache analogue).

    ``tau_eff == 1``: every k-gram of the window is frequent, so the
    dictionary is built from the emit's own window records.  Otherwise it is
    the hashes of this round's frequent output, as in the paper: one copy of
    the host ``stats_k.grams`` back to the device.
    """
    if tau_eff == 1:
        n_l = packing.n_lanes(cfg.sigma, cfg.vocab_size)
        return membership_hashes(emit_extras["window_records"][:, :n_l],
                                 emit_extras["window_valid"])
    grams = torch.as_tensor(stats_k.grams, device=tok_ext.device)
    freq_lane = packing.pack_terms(grams, vocab_size=cfg.vocab_size)
    return membership_hashes(freq_lane, torch.as_tensor(stats_k.lengths == k,
                                                        device=tok_ext.device))


def plan(cfg: NGramConfig) -> plan_mod.JobPlan:
    """APRIORI-SCAN as a :class:`JobPlan`: sigma chained jobs, candidate emit
    pruned by the previous round's dictionary carry, whole-gram counting."""
    return plan_mod.JobPlan(
        name="apriori_scan",
        map=plan_mod.MapStage(_plan_emit),
        shuffle=plan_mod.ShuffleStage("gram"),
        sort=plan_mod.SortStage(),
        reduce=plan_mod.ReduceStage("exact"),
        rounds=cfg.sigma,
        stop_on_empty=True,
        update_carry=_update_carry,
    )


def _run_distributed(tokens, cfg: NGramConfig, mesh, device) -> NGramStats:
    """APRIORI-SCAN across the ranks of ``mesh``: one distributed job a
    round (every rank calls it with the same arguments and gets the same
    output).  Counters as ``repro``'s: summed over the rounds, with no
    ``capacity`` or ``retries``."""
    n_l = packing.n_lanes(cfg.sigma, cfg.vocab_size)
    rec_bytes = packing.record_bytes(cfg.sigma, cfg.vocab_size)
    tok_ext, n_local = shard_with_halo(tokens, cfg.sigma, mesh, device)
    counters = {"jobs": 0, "map_records": 0, "shuffle_records": 0,
                "shuffle_bytes": 0, "overflow": 0}
    out = None
    freq = None
    for k in range(1, cfg.sigma + 1):
        records, valid, _ = _plan_emit(tok_ext, None, n_local, cfg, freq, k)
        local, _, _ = shuffle.shuffle(
            records, gram_hash(records[:, :n_l]), valid, mesh=mesh,
            capacity=pair_capacity(cfg, n_local, mesh))
        (n_cand,) = mesh.sum_ints(valid.sum())
        del records, valid
        stage = gather_stats(count_exact_grams(local, sigma=cfg.sigma,
                                               vocab_size=cfg.vocab_size),
                             cfg.tau, mesh)
        del local
        add_counters(counters, jobs=1, map_records=n_cand, shuffle_records=n_cand,
                     shuffle_bytes=n_cand * rec_bytes)
        out = stage if out is None else out.merged_with(stage)
        if len(stage) == 0:
            break
        grams = torch.as_tensor(stage.grams, device=device)
        freq = membership_hashes(packing.pack_terms(grams, vocab_size=cfg.vocab_size),
                                 torch.as_tensor(stage.lengths == k, device=device))
    out.counters = counters
    return out


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run an APRIORI-SCAN job.  ``tokens``: 1-D, PAD(0)-separated documents;
    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of P > 1 ranks
    runs the distributed rounds.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    if mesh_size(mesh) > 1:
        return _run_distributed(tokens, cfg, mesh, resolve_device(device))
    return run_single_device(tokens, cfg, plan(cfg), device=device)
