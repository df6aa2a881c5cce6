"""NAIVE (Algorithm 1): word counting extended to all n-grams up to sigma
(port of the single-device parts of ``repro.core.naive``).

The map phase emits *every* n-gram occurrence -- O(|d| * sigma) records of
O(sigma) bytes per document, the paper's worst case and the reason the
method drowns in shuffle traffic for large sigma (Figs 4-5).  The reduce
phase is a plain count per distinct gram; the shuffle hashes the whole gram.
On a mesh of P > 1 ranks each rank explodes its own row of the corpus (with
the sigma - 1 token halo) and exchanges the grams by whole-gram hash, as
``repro``'s ``shard_map`` job.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.launch.mesh import mesh_size
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle
from repro_torch.pipeline import plan as plan_mod
from .common import (count_exact_grams, gather_stats, gram_hash, pair_capacity,
                     prefix_masks, run_single_device, shard_with_halo,
                     suffix_lanes, term_present)
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


def _distributed(tokens, cfg: NGramConfig, mesh, device) -> NGramStats:
    """One NAIVE job across the ranks of ``mesh`` (every rank calls it with
    the same arguments and gets the same output).  A pair's capacity scales
    with sigma: each position emits up to sigma grams."""
    n_l = packing.n_lanes(cfg.sigma, cfg.vocab_size)
    tok_ext, n_local = shard_with_halo(tokens, cfg.sigma, mesh, device)
    records, valid, _ = _plan_emit(tok_ext, None, n_local, cfg, None, 1)
    local, capacity, retries = shuffle.shuffle(
        records, gram_hash(records[:, :n_l]), valid, mesh=mesh,
        capacity=pair_capacity(cfg, n_local, mesh, cfg.sigma))
    (map_rec,) = mesh.sum_ints(valid.sum())
    del records, valid
    dense = count_exact_grams(local, sigma=cfg.sigma, vocab_size=cfg.vocab_size)
    del local
    return gather_stats(dense, cfg.tau, mesh, {
        "map_records": map_rec, "shuffle_records": map_rec,
        "shuffle_bytes": map_rec * packing.record_bytes(cfg.sigma, cfg.vocab_size),
        "jobs": 1, "overflow": 0, "capacity": capacity, "retries": retries})


def run(tokens, cfg: NGramConfig, mesh=None, *, device=None) -> NGramStats:
    """Run a NAIVE job.  ``tokens``: 1-D, PAD(0)-separated documents;
    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of P > 1 ranks
    runs the distributed job.

    Runs on the card unless ``device`` says otherwise (see
    :func:`repro_torch.resolve_device`).
    """
    if mesh_size(mesh) > 1:
        return _distributed(tokens, cfg, mesh, resolve_device(device))
    return run_single_device(tokens, cfg, plan(cfg), device=device)
