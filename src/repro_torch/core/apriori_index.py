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
the paper.  The distributed job waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.pipeline import plan as plan_mod
from .common import kgram_records, run_single_device
from .stats import NGramConfig, NGramStats

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


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run an APRIORI-INDEX job.  ``tokens``: 1-D, PAD(0)-separated documents.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    return run_single_device(tokens, cfg, plan(cfg), mesh=mesh, device=device)
