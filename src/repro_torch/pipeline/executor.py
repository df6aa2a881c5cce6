"""Single-device job execution (port of ``run_plan`` and its stage core from
``repro.pipeline.executor``).

``run_plan`` runs a :class:`~repro_torch.pipeline.plan.JobPlan` over the
whole corpus at once, on the device the tokens lie on: every round's map
emit, then the stage core (combine -> shuffle key and skew histogram -> sort
-> reduce), then a host materialize into ``NGramStats``.  Output rows are in
canonical order (``stages.canonical_stats``) and the counters are exactly
``repro``'s.  The multi-round plans (APRIORI-SCAN/-INDEX) hand each round's
carry to the next here.  The wave engine waits for a later slice.

Spans ``plan.run`` and ``round.{emit,stages,materialize}`` mark the phases;
``round.materialize`` also covers the next round's carry.  PyTorch launches
asynchronously, so with tracing on the spans synchronize the card at their
close: their durations then cover the device work they launched.
"""
from __future__ import annotations

import torch

from repro_torch import u32_words
from repro_torch.kernels import ops as kops
from repro_torch.mapreduce import pack as packing
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.pipeline import stages
from repro_torch.pipeline.plan import JobPlan, plan_for

_SKEW_BUCKETS = 64   # nominal reducer count for the shuffle-skew counter


def _stage_core_impl(records, valid, *, n_lanes: int, has_bucket: bool,
                     combine_route: str | None, sigma: int, lane_vocab: int,
                     shuffle_key: str, reduce_kind: str,
                     with_positions: bool = False, n_buckets: int = 0):
    """combine -> shuffle-key -> sort -> reduce over one round's records.

    ``has_bucket``: the records end with a time-series bucket lane, which the
    combiner keeps apart and ``n_buckets > 0`` counts per bucket.

    Returns (dense reducer outputs, map-record count, post-combine live-record
    count, partition histogram over ``_SKEW_BUCKETS`` nominal reducers); the
    counts stay device tensors until the caller's materialize.  The dense
    outputs of the ``"exact"`` reducer with ``with_positions`` end with the
    run total of every position.
    """
    map_rec = valid.sum()
    if combine_route is not None:
        records = stages.combine(records, n_lanes, has_bucket,
                                 route=combine_route)
    live = records[:, n_lanes] > 0
    shuffled = live.sum()
    key = stages.partition_keys(records, n_lanes, kind=shuffle_key,
                                vocab_size=lane_vocab)
    # the real partitioner's bucketing (hash_u32 % P, invalid -> P), so the
    # skew counter measures realized reducer load, not raw-key spread
    _, hist = kops.hash_partition(key, live, n_parts=_SKEW_BUCKETS)
    rec = stages.sort_stage(records, n_keys=n_lanes)
    if reduce_kind == "suffix":
        dense = stages.reduce_suffix(rec, sigma=sigma, vocab_size=lane_vocab,
                                     n_buckets=n_buckets)
    else:
        dense = stages.reduce_exact(rec, sigma=sigma, vocab_size=lane_vocab,
                                    with_positions=with_positions)
    return dense, map_rec, shuffled, hist


def materialize(dense, tau: int):
    """Dense reducer output -> host ``NGramStats``.

    ``NGramStats.from_dense`` computed on the device, so that only the kept
    (flag, cf >= tau) cells leave it: each cell's row of terms, cut to its
    length, and its count, in ``from_dense``'s row-major order.  Series
    counts [N, sigma, B] are kept by their sum over the buckets, taken in
    int32 as the cells are: an int64 sum would first copy the whole
    [N, sigma, B] tensor to int64.
    """
    from repro_torch.core.stats import NGramStats
    terms, flags, counts = dense
    total = counts.sum(dim=-1, dtype=torch.int32) if counts.dim() == 3 else counts
    rows, lens0 = (flags & (total >= tau)).nonzero().unbind(1)
    lengths = (lens0 + 1).to(torch.int32)
    grams = terms[rows] * (torch.arange(terms.shape[1], device=terms.device)
                           < lengths[:, None])
    return NGramStats(grams.to(torch.int32).cpu().numpy(), lengths.cpu().numpy(),
                      counts[rows, lens0].to(torch.int64).cpu().numpy())


def _run_rounds(tok_ext, aux_ext, n_live: int, cfg, plan: JobPlan,
                tau_eff: int, counters: dict):
    """All of a plan's rounds over one token window -> merged ``NGramStats``."""
    from repro_torch.core.stats import add_counters

    lane_vocab = plan.effective_lane_vocab(cfg)
    n_l = packing.n_lanes(cfg.sigma, lane_vocab)
    has_bucket = aux_ext is not None
    n_meta = plan.map.n_meta + (1 if has_bucket else 0)
    rec_bytes = packing.record_bytes(cfg.sigma, lane_vocab, n_meta=n_meta)
    combine_route = plan.combine.route if plan.combine is not None else None

    out = None
    carry = None
    for k in range(1, plan.rounds + 1):
        with obs_trace.span("round.emit") as sp:
            records, valid, emit_extras = plan.map.emit(
                tok_ext, aux_ext, n_live, cfg, carry, k)
            if sp:
                sp.set(round=k)
                sp.sync(records)
        with obs_trace.span("round.stages") as sp:
            dense, map_rec, shuffled, hist = _stage_core_impl(
                records, valid, n_lanes=n_l, has_bucket=has_bucket,
                combine_route=combine_route,
                sigma=cfg.sigma, lane_vocab=lane_vocab,
                shuffle_key=plan.shuffle.key, reduce_kind=plan.reduce.kind,
                with_positions=plan.reduce.with_positions,
                n_buckets=cfg.n_buckets)
            del records, valid
            if sp:
                sp.set(round=k)
                sp.sync(dense)
        with obs_trace.span("round.materialize") as sp:
            if sp:
                sp.set(round=k)
            stats_k = materialize(dense[:3], tau_eff)
            reduce_extras = ({"totals_pos": dense[3]}
                             if plan.reduce.with_positions else {})
            del dense
            last = k == plan.rounds or (plan.stop_on_empty and len(stats_k) == 0)
            if not last and plan.update_carry is not None:
                # the next round's carry; APRIORI-SCAN's copies this round's
                # frequent grams from the host back to the device, as repro does
                carry = plan.update_carry(cfg, tau_eff, k, tok_ext, stats_k,
                                          reduce_extras, emit_extras, carry)
                if sp:
                    sp.sync(carry)
            del reduce_extras, emit_extras
        map_rec = int(map_rec)
        shuffled = int(shuffled)
        hist = hist.cpu().numpy()
        add_counters(counters, jobs=1, map_records=map_rec,
                     shuffle_records=shuffled,
                     shuffle_bytes=shuffled * rec_bytes)
        if shuffled:
            skew = float(hist.max() * _SKEW_BUCKETS / max(hist.sum(), 1))
            counters["shuffle_skew"] = max(counters.get("shuffle_skew", 0.0),
                                           skew)
        out = stats_k if out is None else out.merged_with(stats_k)
        if last:
            break
    out.counters = counters
    return out


def run_plan(tokens: torch.Tensor, cfg, bucket_ids=None,
             plan: JobPlan | None = None):
    """One-wave (whole-corpus) plan execution -- the single-device job.

    ``tokens`` is a 1-D int32 tensor; the job runs on its device.
    ``bucket_ids``: one time-series bucket a position (SSVI-B), read as
    uint32 as ``repro`` reads them; with ``cfg.n_buckets > 0`` the counts
    are per-bucket series.  Output rows are in canonical segment order,
    counters as ``repro``'s ``run_plan``.
    """
    plan = plan or plan_for(cfg)
    with obs_trace.span("plan.run") as sp:
        if sp:
            sp.set(method=cfg.method, rounds=plan.rounds)
        aux = None
        if bucket_ids is not None:
            aux = u32_words(bucket_ids, tokens.device)
            if aux.shape != tokens.shape:
                raise ValueError(f"bucket_ids: one a position, {tuple(tokens.shape)}; "
                                 f"got {tuple(aux.shape)}")
        counters = dict.fromkeys(
            ("jobs", "map_records", "shuffle_records", "shuffle_bytes",
             "retries", "overflow"), 0)
        counters["shuffle_skew"] = 0.0
        out = _run_rounds(tokens, aux, int(tokens.shape[0]), cfg, plan,
                          cfg.tau, counters)
        out.counters = obs_metrics.normalize_counters(out.counters)
        return stages.canonical_stats(out)
