"""APRIORI-SCAN (Algorithm 2): one scan of the corpus per gram length (port of
the single-device parts of ``repro.core.apriori_scan``).

Job k emits only those k-grams whose two constituent (k-1)-grams were output
(frequent) by job k-1 -- candidate pruning by the APRIORI principle.  The
paper keeps the previous job's output in a per-node dictionary (distributed
cache / BerkeleyDB); here it is a sorted array of gram hashes probed by
binary search (``common.membership_hashes``).  A hash collision only admits
an extra candidate, which job k's exact count filters again.

Termination matches the paper: after sigma jobs or when a job outputs
nothing.  The distributed job waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.mapreduce import pack as packing
from repro_torch.pipeline import plan as plan_mod
from .common import (gram_hash, kgram_records, member, membership_hashes,
                     prefix_masks, run_single_device, suffix_lanes)
from .stats import NGramConfig, NGramStats

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


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run an APRIORI-SCAN job.  ``tokens``: 1-D, PAD(0)-separated documents.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    return run_single_device(tokens, cfg, plan(cfg), mesh=mesh, device=device)
