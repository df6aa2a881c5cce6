"""NAIVE (Algorithm 1): word counting extended to all n-grams up to sigma
(port of the single-device parts of ``repro.core.naive``).

The map phase emits *every* n-gram occurrence -- O(|d| * sigma) records of
O(sigma) bytes per document, the paper's worst case and the reason the
method drowns in shuffle traffic for large sigma (Figs 4-5).  The reduce
phase is a plain count per distinct gram; the shuffle hashes the whole gram.
The distributed job waits for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.pipeline import plan as plan_mod
from .common import prefix_masks, run_single_device, suffix_lanes, term_present
from .stats import NGramConfig, NGramStats

__all__ = ["plan", "run"]


def _explode(tokens: torch.Tensor, sigma: int, vocab_size: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map emit: every (position, length <= sigma) n-gram.

    Returns (records [N * sigma, n_lanes + 1] int64 = lanes | weight, valid
    [N * sigma] bool); row ``i`` is the gram of length ``i % sigma + 1`` at
    position ``i // sigma``, zero where the position's suffix is shorter.
    One broadcast AND of the suffix lanes with the prefix masks, written
    into one preallocated matrix.
    """
    lanes = suffix_lanes(tokens, sigma, vocab_size)
    n, n_l = lanes.shape
    valid = term_present(lanes, sigma, vocab_size)              # [N, sigma]
    records = torch.empty((n, sigma, n_l + 1), dtype=torch.int64,
                          device=lanes.device)
    grams = records[:, :, :n_l]
    torch.bitwise_and(lanes[:, None, :],
                      prefix_masks(sigma, vocab_size, lanes.device)[None, 1:],
                      out=grams)
    grams *= valid[:, :, None]
    records[:, :, n_l] = valid
    return records.view(n * sigma, n_l + 1), valid.view(-1)


def _plan_emit(tok_ext, aux_ext, n_live, cfg: NGramConfig, carry, k):
    """Map emit: every (position, length <= sigma) n-gram of the window.  Row
    ``i`` belongs to position ``i // sigma``; positions >= n_live emit nothing."""
    if aux_ext is not None:
        raise NotImplementedError("bucket ids (time series) belong to "
                                  "SUFFIX-sigma alone, as in repro")
    records, valid = _explode(tok_ext, cfg.sigma, cfg.vocab_size)
    if n_live < tok_ext.shape[0]:
        pos_ok = (torch.arange(records.shape[0], device=records.device)
                  // cfg.sigma) < n_live
        valid = valid & pos_ok
        records = records * valid[:, None]
    return records, valid, {}


def plan(cfg: NGramConfig) -> plan_mod.JobPlan:
    """NAIVE as a :class:`JobPlan`: one job, exploded emit (the paper's
    worst-case record volume), whole-gram hash partitioning, exact count."""
    return plan_mod.JobPlan(
        name="naive",
        map=plan_mod.MapStage(_plan_emit),
        shuffle=plan_mod.ShuffleStage("gram"),
        sort=plan_mod.SortStage(),
        reduce=plan_mod.ReduceStage("exact"),
    )


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run a NAIVE job.  ``tokens``: 1-D, PAD(0)-separated documents.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    return run_single_device(tokens, cfg, plan(cfg), mesh=mesh, device=device)
