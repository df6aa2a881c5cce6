"""n-gram statistics job launcher -- the paper's CLI (port of
``repro.launch.ngram``).

    PYTHONPATH=src python -m repro_torch.launch.ngram --method suffix_sigma \
        --sigma 5 --tau 10 --tokens 500000 --profile nyt

Runs the selected method on a synthetic corpus with the paper's measurement
counters (wallclock / records / bytes), optionally with maximality/closedness
post-filtering and time-series aggregation.  ``--wave-tokens`` streams the
job out of core through the wave engine.  The job runs on the card
(``--device cpu`` runs the kernels' plain versions on the host instead).

``--devices N`` runs the job across N local ranks
(:func:`repro_torch.launch.mesh.spawn_ranks`): gloo ranks on the CPU with
``--device cpu``; on the card, NCCL when the host has a card for each rank,
else gloo ranks sharing the card.  With ``--wave-tokens`` every wave runs
across the ranks (the mesh waves).  Rank 0 prints what ``repro``'s
``ngram --devices N`` prints, and writes the trace and metrics files.

Where this CLI differs from ``repro``'s:

  * ``--merge-route`` defaults to ``merge`` (the ``merge_path`` tree on the
    card), where ``repro`` defaults to ``kway``: the port's ``kway`` folds
    on the host.  Every route gives the same output.
  * ``--device`` picks the device; ``repro`` follows JAX's backend.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.mesh import spawn_ranks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="suffix_sigma",
                    choices=["suffix_sigma", "naive", "apriori_scan",
                             "apriori_index"])
    ap.add_argument("--sigma", type=int, default=5)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--tokens", type=int, default=200_000)
    ap.add_argument("--profile", default="nyt", choices=["nyt", "cw"])
    ap.add_argument("--split-docs", action="store_true")
    ap.add_argument("--filter", default=None, choices=[None, "max", "closed"])
    ap.add_argument("--series", action="store_true",
                    help="aggregate per-year n-gram time series (SSVI-B)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--wave-tokens", type=int, default=None,
                    help="out-of-core: run the job in fixed-size token waves "
                         "(repro_torch.pipeline.WaveExecutor); output is "
                         "identical to the monolithic run")
    ap.add_argument("--accumulator", default="defer",
                    choices=["defer", "tiered", "pairwise"],
                    help="wave-partial fold policy: defer = stack wave "
                         "segments and fold once at the end (the default); "
                         "tiered = size-tiered LSM rungs; pairwise = the "
                         "one-segment baseline")
    ap.add_argument("--merge-route", default="merge",
                    choices=["kway", "merge", "sort", "device"],
                    help="segment-fold route: merge = merge_path tree on "
                         "the device (default); device = another name for "
                         "merge; sort = fused re-sort; kway = host merge")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the per-wave fold on the calling thread "
                         "instead of the fold thread")
    ap.add_argument("--devices", type=int, default=0,
                    help=">1: run the job across N local ranks (with "
                         "--wave-tokens, every wave across them)")
    ap.add_argument("--device", default=None,
                    help="device the job runs on: the card unless cpu is "
                         "given (no card: the run raises)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="export a Chrome/Perfetto trace_event JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="append a metrics snapshot (JSONL) and print the "
                         "summary table")
    args = ap.parse_args(argv)
    if args.devices > 1:
        spawn_ranks(args.devices, run, args, device=args.device)
    else:
        run(None, args)


def run(mesh, args) -> None:
    """The job of ``args``, on one device (``mesh`` None) or as one rank of
    ``mesh``; only rank 0 prints and records the trace and metrics."""
    from repro_torch.core import NGramConfig, extensions_filter, run_job
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import report as obs_report

    leader = mesh is None or mesh.rank == 0
    say = print if leader else _silent
    finish_obs = obs_report.setup(args.trace, args.metrics) if leader else _silent
    device = args.device if mesh is None else mesh.device
    if mesh is not None:
        say(f"mesh: {mesh.size} ranks on {mesh.device.type}, backend {mesh.backend}")

    prof = corpus_mod.PROFILES[args.profile]
    if args.series:
        tokens, years = corpus_mod.zipf_corpus(args.tokens, prof, seed=0,
                                               duplicate_frac=0.02, with_years=True)
    else:
        tokens = corpus_mod.zipf_corpus(args.tokens, prof, seed=0,
                                        duplicate_frac=0.02)
        years = None
    if args.split_docs:
        tokens, removed = corpus_mod.split_at_infrequent(tokens, args.tau,
                                                         prof.vocab_size)
        say(f"document splitting removed {removed} infrequent term occurrences")

    cfg = NGramConfig(sigma=args.sigma, tau=args.tau, vocab_size=prof.vocab_size,
                      method=args.method, n_buckets=21 if args.series else 0)
    t0 = time.time()
    if args.wave_tokens is not None:
        from repro_torch.pipeline import WaveExecutor
        if args.series:
            raise SystemExit("--wave-tokens does not support --series "
                             "(bucketed counts need a single-wave job)")
        stats = WaveExecutor(cfg, wave_tokens=args.wave_tokens,
                             accumulator=args.accumulator,
                             merge_route=args.merge_route,
                             overlap=not args.no_overlap, mesh=mesh,
                             device=device).run(tokens)
    else:
        kw = {"bucket_ids": years} if args.series else {}
        stats = run_job(tokens, cfg, mesh, device=device, **kw)
    dt = time.time() - t0
    if args.filter:
        stats = extensions_filter(stats, args.filter, device=device)
    obs_metrics.get_registry().merge_job_counters(stats.counters)
    say(f"method={args.method} sigma={args.sigma} tau={args.tau} "
          f"tokens={args.tokens}: {len(stats)} n-grams in {dt:.2f}s")
    say("counters:", {k: int(v) for k, v in stats.counters.items()})
    d = stats.to_dict()
    top = sorted(d.items(), key=lambda kv: -kv[1])[: args.top]
    for g, c in top:
        say(f"  cf={c:8d}  {g}")
    finish_obs({"driver": "ngram", "method": args.method,
                "tokens": args.tokens, "wall_s": dt})


def _silent(*args, **kwargs) -> None:
    """What a rank other than 0 prints and records: nothing."""


if __name__ == "__main__":
    main()
