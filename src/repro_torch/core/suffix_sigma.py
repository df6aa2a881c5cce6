"""SUFFIX-sigma (Algorithm 4 of the paper) as a single-device PyTorch job
(port of the non-mesh parts of ``repro.core.suffix_sigma``).

Phases (one MapReduce job, like the paper):

  map      -- per token position emit the sigma-truncated suffix as packed
              lanes with weight 1 (the ``suffix_pack`` kernel); an optional
              map-side combine merges equal suffixes.
  shuffle  -- partition by hash(first term); on one device the partition
              histogram (the ``hash_partition`` kernel) feeds ``shuffle_skew``.
  sort     -- lexicographic multi-key sort of the packed lanes.
  reduce   -- LCP boundaries between adjacent sorted suffixes delimit the runs
              of every distinct prefix (the ``lcp_boundary`` kernel); run
              totals are segmented sums of the weights.

The distributed job, ``sigma_split`` and bucketed series wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import suffix_windows
from repro_torch.mapreduce import pack as packing
from repro_torch.pipeline import plan as plan_mod
from .common import run_single_device
from .stats import NGramConfig, NGramStats

__all__ = ["suffix_windows", "make_records", "plan", "run"]


def make_records(tokens: torch.Tensor, *, sigma: int, vocab_size: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Map emit: [N, n_lanes + 1] int64 records = packed lanes | weight.

    The ``suffix_pack`` kernel writes whole records, weight included, in one
    pass: no lane matrix to copy, and no column written apart (a column
    alone fills a part of each 32-byte memory sector, which costs the card a
    read of the rest).
    """
    n_l = packing.n_lanes(sigma, vocab_size)
    records = torch.empty((tokens.shape[0], n_l + 1), dtype=torch.int64,
                          device=tokens.device)
    kops.suffix_pack(tokens, sigma=sigma, vocab_size=vocab_size, out=records)
    return records, tokens != 0


def _plan_emit(tok_ext, aux_ext, n_live, cfg: NGramConfig, carry, k):
    """Map emit over one token window; positions >= n_live carry no weight."""
    if aux_ext is not None:
        raise NotImplementedError("bucket ids (time series) are not ported to "
                                  "repro_torch yet")
    records, valid = make_records(tok_ext, sigma=cfg.sigma,
                                  vocab_size=cfg.lane_vocab)
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


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run a SUFFIX-sigma job.  ``tokens``: 1-D, PAD(0)-separated documents.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    return run_single_device(tokens, cfg, plan(cfg), mesh=mesh, device=device)
