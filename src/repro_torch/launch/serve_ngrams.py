"""n-gram query serving driver: job -> frozen index -> micro-batched QPS
report (port of ``repro.launch.serve_ngrams``).

    PYTHONPATH=src python -m repro_torch.launch.serve_ngrams --tokens 200000 \
        --sigma 5 --tau 4 --profile nyt --batch-sizes 1,64,4096

Runs one SUFFIX-sigma job, freezes the output into the device-resident index
(``repro_torch.index``), then drives a synthetic query stream through the
batched lookup and top-k continuation paths with fixed-size micro-batches
and reports QPS and per-batch latency percentiles per batch size.

``--streaming`` switches to the generational driver: the corpus arrives in
document batches, each runs through the job into a fresh L0 segment of a
:class:`~repro_torch.index.merge.GenerationalIndex` (size-tiered merges
instead of full rebuilds), and queries keep flowing between swaps through
an LRU result cache plus double-buffered dispatch.  ``--wave-tokens``
streams each ingest through the wave engine.

``--serve HOST:PORT`` turns the process into the frontend
(``repro_torch.serve``): the corpus is ingested once, then the HTTP/SSE
service answers point-lookup / top-k / streaming-completion requests
through the continuous batcher and admission layer until interrupted.

``--devices N`` (N > 1) runs N local ranks
(:func:`repro_torch.launch.mesh.spawn_ranks`, the backend rule of
``launch/mesh.py``): the micro-batch mode serves through the hash-routed
sharded index across them; ``--streaming`` runs every ingest's job across
them (the mesh waves with ``--wave-tokens``), each rank keeping the same
generational index, and rank 0 alone answers the query loop.  Rank 0
prints and records the trace and metrics.  ``--serve`` with ``--devices``
serves from one device, as ``repro``'s does.

Everything runs on the card (``--device cpu`` runs the kernels' plain
versions on the host instead).  Where this CLI differs from ``repro``'s:

  * ``--use-kernels`` is gone: the device of the data decides whether a
    kernel runs (a CUDA tensor launches it, a CPU tensor runs its plain
    version).
  * The streaming service compacts on the ``merge`` route (the card),
    where ``repro``'s defaults to ``kway``; every route gives the same index.

This module is a thin argument-parsing shell: the serving tier itself lives
in ``repro_torch.serve``.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.mesh import spawn_ranks

_REEXPORTS = {
    # lazy (PEP 562), as repro's driver keeps them: importing this module
    # imports no layer of the serving tier
    "LRUQueryCache": ("repro_torch.serve.cache", "LRUQueryCache"),
    "StreamingNGramService": ("repro_torch.serve.service", "StreamingNGramService"),
    "microbatch_drive": ("repro_torch.serve.service", "microbatch_drive"),
    "make_query_stream": ("repro_torch.serve.service", "make_query_stream"),
    "DoubleBufferedDriver": ("repro_torch.pipeline.executor", "DoubleBufferedDriver"),
}


def __getattr__(name):
    try:
        mod_name, attr = _REEXPORTS[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def _percentiles(lat_s: list[float]) -> str:
    import numpy as np
    a = np.asarray(lat_s) * 1e3
    return (f"p50={np.percentile(a, 50):.2f}ms p99={np.percentile(a, 99):.2f}ms "
            f"max={a.max():.2f}ms")


def _build_streaming_service(args, mesh=None):
    """Corpus + config + service, shared by --streaming and --serve; with a
    ``mesh``, this rank's service."""
    from repro_torch.core.stats import NGramConfig
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.serve.service import StreamingNGramService

    prof = corpus_mod.PROFILES[args.profile]
    tokens = corpus_mod.zipf_corpus(args.tokens, prof, seed=0,
                                    duplicate_frac=0.02)
    cfg = NGramConfig(sigma=args.sigma, tau=args.tau,
                      vocab_size=prof.vocab_size)
    svc = StreamingNGramService(cfg, compress=args.compress,
                                block_size=args.block_size,
                                cache_capacity=args.cache_capacity,
                                wave_tokens=args.wave_tokens,
                                overlap=not args.no_overlap, mesh=mesh,
                                device=args.device if mesh is None else mesh.device)
    return prof, tokens, svc


def run_serve(args) -> None:
    """Frontend mode: ingest once, then answer HTTP/SSE until interrupted."""
    from repro_torch.serve.admission import AdmissionController
    from repro_torch.serve.frontend import QueryFrontend
    from repro_torch.serve.http import serve_http

    host, _, port = args.serve.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"--serve wants HOST:PORT, got {args.serve!r}")
    _, tokens, svc = _build_streaming_service(args)
    rep = svc.ingest(tokens)
    print(f"ingested {len(tokens)} tokens -> {rep['ingested_rows']} grams "
          f"(job {rep['job_s']:.2f}s, freeze {rep['ingest_s']:.2f}s)")
    admission = AdmissionController(
        queue_budget=args.queue_budget,
        quota_rate=args.quota_rate if args.quota_rate > 0 else None)
    with QueryFrontend(svc, admission=admission,
                       deadline_s=args.deadline_ms / 1e3) as fe:
        print(f"serving on http://{host}:{port}  "
              "(POST /v1/lookup /v1/topk /v1/complete; "
              "GET /v1/system/topology /healthz)")
        serve_http(fe, host, int(port), block=True)


def run_streaming(mesh, args) -> None:
    """Generational serving loop: base build, then ingest/query interleave.
    With a ``mesh`` (one rank of it) every ingest runs across the ranks;
    rank 0 answers the queries, prints, and records the trace and metrics."""
    import numpy as np
    from repro_torch.index.merge import segment_to_stats
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import report as obs_report
    from repro_torch.serve.service import make_query_stream

    leader = mesh is None or mesh.rank == 0
    finish_obs = obs_report.setup(args.trace, args.metrics) if leader else None
    if mesh is not None and leader:
        print(f"mesh: {mesh.size} ranks on {mesh.device.type}, backend {mesh.backend}")
    prof, tokens, svc = _build_streaming_service(args, mesh)
    nb = max(args.ingest_batches, 1)
    base, rest = np.split(tokens, [int(len(tokens) * 0.6)])
    deltas = np.array_split(rest, nb)
    rep = svc.ingest(base)
    if leader:
        print(f"base: {len(base)} tokens -> {rep['ingested_rows']} grams "
              f"(job {rep['job_s']:.2f}s, freeze {rep['ingest_s']:.2f}s)")

    batch = args.stream_batch
    for step, delta in enumerate(deltas):
        t0 = time.perf_counter()
        rep = svc.ingest(delta)
        t_ing = time.perf_counter() - t0
        if not leader:
            continue
        stats = segment_to_stats(svc.gen.segments[0].to_segment())
        # fresh query stream per step (seed=step), split in two cold halves:
        # one drives the pipelined path (throughput), one the per-batch sync
        # path (latency percentiles)
        grams, lengths = make_query_stream(
            stats, n_queries=args.queries // nb, sigma=args.sigma,
            vocab_size=prof.vocab_size, miss_frac=args.miss_frac,
            seed=step)
        half = grams.shape[0] // 2
        pipe_b = [(grams[i:i + batch], lengths[i:i + batch])
                  for i in range(0, half, batch)]
        sync_b = [(grams[i:i + batch], lengths[i:i + batch])
                  for i in range(half, grams.shape[0], batch)]
        svc.lookup(*pipe_b[0])                 # first launches only
        t0 = time.perf_counter()
        svc.lookup_pipelined(pipe_b)
        t_pipe = time.perf_counter() - t0
        lat = []
        lat_hist = obs_metrics.get_registry().histogram("serve.lookup_seconds")
        for g, ln in sync_b:
            t1 = time.perf_counter()
            svc.lookup(g, ln)
            dt = time.perf_counter() - t1
            lat.append(dt)
            lat_hist.observe(dt)
        svc.cache.publish_metrics()
        n_pipe = sum(b[0].shape[0] for b in pipe_b)
        print(f"ingest[{step}]: {len(delta):>7} tokens in {t_ing:.2f}s "
              f"({len(delta) / t_ing:,.0f} tok/s; waves={rep['waves']} "
              f"merges={rep['merges']} segments={rep['segments']}) | pipelined "
              f"{n_pipe / t_pipe:>8,.0f} qps | sync {_percentiles(lat)} "
              f"cache_hit={svc.cache.hit_rate:.0%}")
    if leader:
        svc.cache.publish_metrics()
        print(f"final: {svc.gen!r}, {svc.gen.nbytes / 2**20:.1f} MiB, "
              f"cache {len(svc.cache)} entries hit_rate={svc.cache.hit_rate:.0%}")
        finish_obs({"driver": "serve_ngrams", "mode": "streaming"})


def run_microbatch(mesh, args) -> None:
    """One job, one frozen index, fixed-size micro-batches of queries; with
    a ``mesh`` (one rank of it) the index is sharded across the ranks and
    only rank 0 prints and records the trace and metrics."""
    import numpy as np
    from repro_torch import index as index_mod
    from repro_torch.core import run_job
    from repro_torch.core.stats import NGramConfig
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve.service import make_query_stream, microbatch_drive

    from repro_torch.obs import report as obs_report

    leader = mesh is None or mesh.rank == 0
    finish_obs = obs_report.setup(args.trace, args.metrics) if leader else None
    device = args.device if mesh is None else mesh.device
    if mesh is not None and leader:
        print(f"mesh: {mesh.size} ranks on {mesh.device.type}, backend {mesh.backend}")
    prof = corpus_mod.PROFILES[args.profile]
    tokens = corpus_mod.zipf_corpus(args.tokens, prof, seed=0, duplicate_frac=0.02)
    cfg = NGramConfig(sigma=args.sigma, tau=args.tau, vocab_size=prof.vocab_size)

    t0 = time.time()
    stats = run_job(tokens, cfg, device=device)
    t_job = time.time() - t0
    obs_metrics.get_registry().merge_job_counters(stats.counters)
    t0 = time.time()
    if mesh is not None:
        sharded = index_mod.build_sharded_index(stats, vocab_size=prof.vocab_size,
                                                mesh=mesh, compress=args.compress,
                                                block_size=args.block_size,
                                                device=device)
        idx_bytes = sharded.nbytes
    elif args.compress:
        idx = index_mod.build_compressed_index(stats, vocab_size=prof.vocab_size,
                                               block_size=args.block_size,
                                               device=device)
        idx_bytes = idx.nbytes
    else:
        idx = index_mod.build_index(stats, vocab_size=prof.vocab_size,
                                    device=device)
        idx_bytes = idx.nbytes
    t_build = time.time() - t0
    layout = "compressed" if args.compress else "flat"
    if leader:
        print(f"job: {args.tokens} tokens -> {len(stats)} frequent grams "
              f"in {t_job:.2f}s; {layout} index frozen in {t_build:.2f}s "
              f"({idx_bytes / 2**20:.1f} MiB, "
              f"{idx_bytes / max(len(stats), 1):.1f} B/gram)")

    grams, lengths = make_query_stream(stats, n_queries=args.queries,
                                       sigma=args.sigma,
                                       vocab_size=prof.vocab_size,
                                       miss_frac=args.miss_frac)

    if mesh is not None:
        def answer_lookup(g, ln):
            return index_mod.serve_queries(sharded, g, ln)

        def answer_topk(g, ln):
            # as repro's sharded driver: prefixes of length >= 1
            return index_mod.serve_queries(sharded, g, np.maximum(ln - 1, 1),
                                           mode="continuations", k=args.topk)
    else:
        def answer_lookup(g, ln):
            return index_mod.lookup(idx, g, ln).cpu().numpy()

        def answer_topk(g, ln):
            # continuations() masks the gram past the prefix length itself
            return index_mod.continuations(idx, g, np.maximum(ln - 1, 0),
                                           k=args.topk)[3].cpu().numpy()

    for mode, answer in (("lookup", answer_lookup), ("topk", answer_topk)):
        for batch in (int(b) for b in args.batch_sizes.split(",")):
            qps, lat = microbatch_drive(answer, grams, lengths, batch,
                                        hist_name=f"drive.{mode}_seconds")
            if leader:
                print(f"serve_{mode} batch={batch:>5} qps={qps:>10.0f} "
                      f"{_percentiles(lat)}")
    if finish_obs is not None:
        finish_obs({"driver": "serve_ngrams", "mode": "microbatch"})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=200_000)
    ap.add_argument("--sigma", type=int, default=5)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--profile", default="nyt", choices=["nyt", "cw"])
    ap.add_argument("--queries", type=int, default=20_000)
    ap.add_argument("--miss-frac", type=float, default=0.3)
    ap.add_argument("--batch-sizes", default="1,64,4096")
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--devices", type=int, default=0,
                    help=">1: run N local ranks: the sharded index, or with "
                         "--streaming every ingest's job across them (--serve "
                         "serves from one device)")
    ap.add_argument("--device", default=None,
                    help="device the index lives on: the card unless cpu is "
                         "given (no card: the run raises)")
    ap.add_argument("--compress", action="store_true",
                    help="serve the front-coded + Elias-Fano layout "
                         "(repro_torch.index.compress) instead of the flat lanes")
    ap.add_argument("--block-size", type=int, default=4,
                    help="front-coding block size of the compressed layout "
                         "(larger = smaller at rest, more rows decoded per "
                         "query probe)")
    ap.add_argument("--streaming", action="store_true",
                    help="generational driver: ingest the corpus in document "
                         "batches (LSM merges, no rebuilds) with cached, "
                         "double-buffered query serving between swaps")
    ap.add_argument("--serve", default=None, metavar="HOST:PORT",
                    help="frontend mode: ingest the corpus once, then run the "
                         "HTTP/SSE service (repro_torch.serve) with continuous "
                         "batching and admission control until interrupted")
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="--serve: continuous-batcher flush deadline for a "
                         "partially filled padding bucket")
    ap.add_argument("--queue-budget", type=int, default=512,
                    help="--serve: admission soft queue budget (beyond it "
                         "only interactive-priority requests are admitted; "
                         "4x is the hard shed limit)")
    ap.add_argument("--quota-rate", type=float, default=0.0,
                    help="--serve: per-tenant token-bucket refill in "
                         "requests/s (0 disables tenant quotas)")
    ap.add_argument("--ingest-batches", type=int, default=4)
    ap.add_argument("--wave-tokens", type=int, default=None,
                    help="stream each ingest through the out-of-core wave "
                         "engine (repro_torch.pipeline) in waves of this many "
                         "tokens; bounds device memory by the wave, not the "
                         "corpus")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run each ingest's per-wave fold on the calling "
                         "thread instead of the wave engine's fold thread")
    ap.add_argument("--stream-batch", type=int, default=256,
                    help="query micro-batch size of the streaming loop")
    ap.add_argument("--cache-capacity", type=int, default=65536)
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="export a Chrome/Perfetto trace_event JSON of the run")
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="append a metrics snapshot (JSONL) and print the "
                         "summary table")
    args = ap.parse_args(argv)
    if args.serve:
        from repro_torch.obs import report as obs_report
        finish_obs = obs_report.setup(args.trace, args.metrics)
        try:
            run_serve(args)
        finally:
            finish_obs({"driver": "serve_ngrams", "mode": "serve"})
        return
    mode = run_streaming if args.streaming else run_microbatch
    if args.devices > 1:
        spawn_ranks(args.devices, mode, args, device=args.device)
    else:
        mode(None, args)


if __name__ == "__main__":
    main()
