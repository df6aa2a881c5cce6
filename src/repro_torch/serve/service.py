"""The query service: generational index + cache behind a batch API (port of
``repro.serve.service``).

``StreamingNGramService`` owns one
:class:`~repro_torch.index.merge.GenerationalIndex` and one
:class:`~repro_torch.serve.cache.LRUQueryCache` and exposes

  * ``ingest(tokens)``         -- job on the delta -> fresh L0 segment swap
  * ``lookup(grams, lengths)`` -- batched point counts (cache first)
  * ``continuations(...)``     -- batched top-k completion rows (cache first)

plus the split ``_submit_lookup`` / ``_collect_lookup`` pair that
``lookup_pipelined`` and the continuous batcher (``serve.batcher``) drive
double-buffered.  Cache hits never touch the device; the miss rows of a
batch go to the index in one dispatch.  Spans: ``svc.ingest``,
``svc.lookup`` and ``svc.continuations``, and inside them (and inside the
split pair) ``svc.cache`` for the keys and the cache's consult (``rows``,
``hits``: only these carry ``rows``, so a sum counts each row once) or its
puts (``puts``), and ``svc.search`` for the miss rows' trip to the index
and back; each carries ``gen``, the index generation it read or wrote,
which the spans of one delta share.  Answers
come back as host numpy int64 arrays of uint32 values.  With
``wave_tokens`` an ingest streams through the wave engine
(``pipeline.WaveExecutor``), so a delta larger than device memory ingests
too.  With a ``mesh`` (a :class:`~repro_torch.launch.mesh.DataMesh`) every
rank builds the service and calls ``ingest`` with the same delta: the job
runs across the ranks (the mesh waves with ``wave_tokens``, the distributed
job otherwise), every rank ingests the same stats into its own index, and
each rank answers queries alone, as ``repro``'s single-controller service
does.

``microbatch_drive`` and ``make_query_stream`` are the synthetic-workload
helpers the CLI drivers share.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from .cache import LRUQueryCache

__all__ = ["StreamingNGramService", "microbatch_drive", "make_query_stream"]


def make_query_stream(stats, *, n_queries: int, sigma: int, vocab_size: int,
                      miss_frac: float, seed: int = 0):
    """(grams [N, sigma], lengths [N]): cf-weighted index rows + uniform misses."""
    rng = np.random.default_rng(seed)
    grams = np.zeros((n_queries, sigma), np.int32)
    lengths = np.zeros((n_queries,), np.int32)
    n_rows = len(stats)
    is_miss = rng.random(n_queries) < miss_frac
    if n_rows:
        p = np.asarray(stats.counts, np.float64)
        p = p / p.sum()
        rows = rng.choice(n_rows, size=n_queries, p=p)
        grams = np.asarray(stats.grams)[rows].astype(np.int32)
        lengths = np.asarray(stats.lengths)[rows].astype(np.int32)
    miss_len = rng.integers(1, sigma + 1, n_queries).astype(np.int32)
    miss_g = rng.integers(1, vocab_size + 1, (n_queries, sigma)).astype(np.int32)
    miss_g *= np.arange(sigma)[None, :] < miss_len[:, None]
    grams = np.where(is_miss[:, None], miss_g, grams)
    lengths = np.where(is_miss, miss_len, lengths)
    return grams, lengths


class StreamingNGramService:
    """Generational index + query cache behind a batch lookup/completion API.

    Runs on the card unless ``device`` says otherwise (no card and no
    ``device``: it raises).  ``route`` defaults to ``"merge"``, not
    ``repro``'s ``"kway"``: the port's ``kway`` compacts on the host, and a
    default service keeps its compactions on the card.  ``overlap`` is the
    wave ingest's fold thread (``WaveExecutor(overlap=)``).  ``mesh``: the
    ranks the ingest's job runs across (a mesh of one is one device).
    """

    #: cache key of one point lookup
    @staticmethod
    def lookup_key(gram, length: int):
        return (int(length), gram[:max(int(length), 0)].tobytes())

    #: cache key of one top-k continuation query
    @staticmethod
    def continuation_key(gram, length: int, k: int):
        return ("c", int(k), int(length), gram[:max(int(length), 0)].tobytes())

    def __init__(self, cfg, *, compress: bool = False, block_size: int = 4,
                 cache_capacity: int = 65536, size_ratio: int = 4,
                 route: str = "merge", wave_tokens: int | None = None, mesh=None,
                 overlap: bool = True, device=None):
        from repro_torch.index.merge import GenerationalIndex
        self.cfg = cfg
        self.wave_tokens = wave_tokens
        self.mesh = mesh
        self.overlap = overlap
        self.gen = GenerationalIndex(
            sigma=cfg.sigma, vocab_size=cfg.vocab_size, compress=compress,
            block_size=block_size, size_ratio=size_ratio, route=route,
            device=device)
        self.cache = LRUQueryCache(cache_capacity)
        self._wave_ex = None

    def ingest(self, tokens) -> dict:
        """Run the job over a token delta and swap the new L0 in.

        With ``wave_tokens`` the delta streams through one reused
        ``WaveExecutor`` instead of one monolithic job; the stats, and so
        the index, are the same either way, and with a ``mesh`` too.
        """
        with obs_trace.span("svc.ingest") as sp:
            t0 = time.perf_counter()
            if self.wave_tokens is not None:
                if self._wave_ex is None:
                    from repro_torch.pipeline import WaveExecutor
                    self._wave_ex = WaveExecutor(self.cfg, wave_tokens=self.wave_tokens,
                                                 mesh=self.mesh, overlap=self.overlap,
                                                 device=self.gen.device)
                stats = self._wave_ex.run(tokens)
            else:
                from repro_torch.core import run_job
                stats = run_job(tokens, self.cfg, self.mesh, device=self.gen.device)
            t_job = time.perf_counter() - t0
            obs_metrics.get_registry().merge_job_counters(stats.counters)
            t0 = time.perf_counter()
            report = self.gen.ingest(stats)
            report.update(job_s=t_job, ingest_s=time.perf_counter() - t0,
                          segments=self.gen.n_segments,
                          waves=stats.counters.get("waves", 1))
            if sp:
                sp.set(tokens=len(tokens), rows=report["ingested_rows"],
                       waves=report["waves"], gen=self.gen.generation)
        return report

    def _cached(self, keys: list, out: np.ndarray, gen_id: int) -> list:
        """Fill ``out`` rows from the cache; return the miss row indices."""
        miss = []
        for i, key in enumerate(keys):
            v = self.cache.get(key, gen_id)
            if v is None:
                miss.append(i)
            else:
                out[i] = v
        return miss

    def _install(self, keys: list, miss: list, values, gen_id: int) -> None:
        """Put the answers of the miss rows, in a ``svc.cache`` span that
        counts the puts (and no rows: the consult counted them)."""
        with obs_trace.span("svc.cache") as sp:
            for i, v in zip(miss, values):
                self.cache.put(keys[i], gen_id, v)
            if sp:
                sp.set(puts=len(miss), gen=gen_id)

    def _submit_lookup(self, grams, lengths) -> dict:
        """Cache consult + device dispatch of the miss rows.  The record holds
        the per-segment answers unread: pairing ``_submit_lookup`` of batch
        i + 1 with ``_collect_lookup`` of batch i is the double-buffered
        path (the cache fills on the collect side, one batch behind)."""
        from repro_torch.index.query import lookup_deferred
        g = np.asarray(grams, np.int32)
        ln = np.asarray(lengths, np.int32)
        gen_id = self.gen.generation
        with obs_trace.span("svc.cache") as sp:
            keys = [self.lookup_key(g[i], int(ln[i])) for i in range(g.shape[0])]
            out = np.zeros((g.shape[0],), np.int64)
            miss = self._cached(keys, out, gen_id)
            if sp:
                sp.set(rows=len(keys), hits=len(keys) - len(miss), gen=gen_id)
        parts = None
        if miss:
            with obs_trace.span("svc.search") as sp:
                if sp:
                    sp.set(gen=gen_id)
                q = [torch.as_tensor(x[miss]) for x in (g, ln)]
                if self.gen.device.type == "cuda":  # a pinned copy does not wait
                    q = [x.pin_memory().to(self.gen.device, non_blocking=True)
                         for x in q]
                parts = lookup_deferred(self.gen, *q)
        return {"out": out, "miss": miss, "keys": keys, "parts": parts,
                "gen": gen_id}

    def _collect_lookup(self, rec: dict) -> np.ndarray:
        from repro_torch.index.query import collect_lookup
        miss = rec["miss"]
        if miss:
            with obs_trace.span("svc.search") as sp:
                if sp:
                    sp.set(gen=rec["gen"])
                cf = (collect_lookup(rec["parts"], len(miss)).cpu().numpy()
                      if rec["parts"] else np.zeros(len(miss), np.int64))
                rec["out"][miss] = cf
            self._install(rec["keys"], miss, cf.tolist(), rec["gen"])
        return rec["out"]

    def lookup(self, grams, lengths) -> np.ndarray:
        """Point counts [B] int64; cache hits never touch the device."""
        with obs_trace.span("svc.lookup") as sp:
            rec = self._submit_lookup(grams, lengths)
            if sp:
                sp.set(gen=rec["gen"])
            return self._collect_lookup(rec)

    def lookup_pipelined(self, batches) -> list:
        """Answer (grams, lengths) batches double-buffered: batch i + 1 is
        dispatched before batch i's answers are read back, so the host's
        cache work and copies overlap the card's searches.  Returns one
        answer array a batch, equal to :meth:`lookup`'s."""
        from repro_torch.pipeline.executor import DoubleBufferedDriver
        drv = DoubleBufferedDriver(self._submit_lookup, collect=self._collect_lookup)
        inflight = obs_metrics.get_registry().gauge("serve.inflight")
        results: list = []
        with obs_trace.span("serve.pipelined") as sp:
            for g, ln in batches:
                inflight.add(1)               # one submitted, maybe one live
                res, _ = drv.submit(g, ln)
                if res is not None:
                    inflight.add(-1)
                    results.append(res)
            res, _ = drv.drain()
            inflight.set(0)
            if res is not None:
                results.append(res)
            if sp:
                sp.set(batches=len(results))
        return results

    def continuations(self, prefixes, p_len, *, k: int = 8) -> np.ndarray:
        """Top-k completion rows [B, 2+2k] int64 (nd | total | terms | cfs)."""
        from repro_torch.index.query import continuations as idx_cont
        with obs_trace.span("svc.continuations") as root:
            pg = np.asarray(prefixes, np.int32)
            pl = np.asarray(p_len, np.int32)
            gen_id = self.gen.generation
            if root:
                root.set(gen=gen_id)
            with obs_trace.span("svc.cache") as sp:
                keys = [self.continuation_key(pg[i], int(pl[i]), k)
                        for i in range(pg.shape[0])]
                out = np.zeros((pg.shape[0], 2 + 2 * k), np.int64)
                miss = self._cached(keys, out, gen_id)
                if sp:
                    sp.set(rows=len(keys), hits=len(keys) - len(miss), gen=gen_id)
            if miss:
                with obs_trace.span("svc.search") as sp:
                    if sp:
                        sp.set(gen=gen_id)
                    nd, tot, terms, cfs = (x.cpu().numpy() for x in
                                           idx_cont(self.gen, pg[miss], pl[miss], k=k))
                    rows = np.concatenate([nd[:, None], tot[:, None], terms, cfs], axis=1)
                    out[miss] = rows
                self._install(keys, miss, rows, gen_id)
        return out


def microbatch_drive(answer, grams, lengths, batch: int, *, warmup: int = 2,
                     hist_name: str = "drive.batch_seconds"):
    """Feed the stream through ``answer`` in fixed micro-batches; (qps, lat[s]).

    Timed batches also land in the ``hist_name`` registry histogram, so the
    p50/p95/p99 come out of the metrics export as well as the returned
    sample list.  ``answer`` must return host values (it is timed until it
    does).
    """
    n = grams.shape[0]
    n_batches = -(-n // batch)
    pad = n_batches * batch - n
    g = np.pad(grams, ((0, pad), (0, 0)))
    ln = np.pad(lengths, (0, pad))
    for i in range(min(warmup, n_batches)):      # first launches + cache warm
        answer(g[i * batch:(i + 1) * batch], ln[i * batch:(i + 1) * batch])
    hist = obs_metrics.get_registry().histogram(hist_name)
    lat = []
    with obs_trace.span("serve.drive") as sp:
        t_all = time.perf_counter()
        for i in range(n_batches):
            t0 = time.perf_counter()
            answer(g[i * batch:(i + 1) * batch], ln[i * batch:(i + 1) * batch])
            dt = time.perf_counter() - t0
            lat.append(dt)
            hist.observe(dt)
        qps = n / (time.perf_counter() - t_all)
        if sp:
            sp.set(batch=batch, n_batches=n_batches, qps=int(qps))
    return qps, lat
