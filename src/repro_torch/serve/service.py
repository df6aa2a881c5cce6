"""The query service: generational index + cache behind a batch API (port of
``repro.serve.service``).

``StreamingNGramService`` owns one
:class:`~repro_torch.index.merge.GenerationalIndex` and one
:class:`~repro_torch.serve.cache.LRUQueryCache` and exposes

  * ``ingest(tokens)``         -- job on the delta -> fresh L0 segment swap
  * ``lookup(grams, lengths)`` -- batched point counts (cache first)
  * ``continuations(...)``     -- batched top-k completion rows (cache first)

Cache hits never touch the device; the miss rows of a batch go to the index
in one call.  Answers come back as host numpy int64 arrays of uint32 values.
The wave-engine ingest (``wave_tokens``), the multi-device job (``mesh``) and
the double-buffered ``lookup_pipelined`` wait for the slices that port them.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.obs import trace as obs_trace
from .cache import LRUQueryCache

__all__ = ["StreamingNGramService", "make_query_stream"]


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
    default service keeps its compactions on the card.
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
                 device=None):
        if wave_tokens is not None:
            raise NotImplementedError("wave-engine ingest (wave_tokens) is not "
                                      "ported to repro_torch yet")
        if mesh is not None:
            raise NotImplementedError("the multi-device job (mesh) is not "
                                      "ported to repro_torch yet")
        from repro_torch.index.merge import GenerationalIndex
        self.cfg = cfg
        self.gen = GenerationalIndex(
            sigma=cfg.sigma, vocab_size=cfg.vocab_size, compress=compress,
            block_size=block_size, size_ratio=size_ratio, route=route,
            device=device)
        self.cache = LRUQueryCache(cache_capacity)

    def ingest(self, tokens) -> dict:
        """Run the job over a token delta and swap the new L0 in."""
        from repro_torch.core import run_job
        with obs_trace.span("svc.ingest") as sp:
            t0 = time.perf_counter()
            stats = run_job(tokens, self.cfg, device=self.gen.device)
            t_job = time.perf_counter() - t0
            t0 = time.perf_counter()
            report = self.gen.ingest(stats)
            report.update(job_s=t_job, ingest_s=time.perf_counter() - t0,
                          segments=self.gen.n_segments, waves=1)
            if sp:
                sp.set(tokens=len(tokens), rows=report["ingested_rows"])
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

    def lookup(self, grams, lengths) -> np.ndarray:
        """Point counts [B] int64; cache hits never touch the device."""
        from repro_torch.index.query import lookup as idx_lookup
        g = np.asarray(grams, np.int32)
        ln = np.asarray(lengths, np.int32)
        gen_id = self.gen.generation
        keys = [self.lookup_key(g[i], int(ln[i])) for i in range(g.shape[0])]
        out = np.zeros((g.shape[0],), np.int64)
        miss = self._cached(keys, out, gen_id)
        if miss:
            cf = idx_lookup(self.gen, g[miss], ln[miss]).cpu().numpy()
            out[miss] = cf
            for i, v in zip(miss, cf.tolist()):
                self.cache.put(keys[i], gen_id, v)
        return out

    def continuations(self, prefixes, p_len, *, k: int = 8) -> np.ndarray:
        """Top-k completion rows [B, 2+2k] int64 (nd | total | terms | cfs)."""
        from repro_torch.index.query import continuations as idx_cont
        pg = np.asarray(prefixes, np.int32)
        pl = np.asarray(p_len, np.int32)
        gen_id = self.gen.generation
        keys = [self.continuation_key(pg[i], int(pl[i]), k)
                for i in range(pg.shape[0])]
        out = np.zeros((pg.shape[0], 2 + 2 * k), np.int64)
        miss = self._cached(keys, out, gen_id)
        if miss:
            nd, tot, terms, cfs = (x.cpu().numpy() for x in
                                   idx_cont(self.gen, pg[miss], pl[miss], k=k))
            rows = np.concatenate([nd[:, None], tot[:, None], terms, cfs], axis=1)
            out[miss] = rows
            for j, i in enumerate(miss):
                self.cache.put(keys[i], gen_id, rows[j])
        return out
