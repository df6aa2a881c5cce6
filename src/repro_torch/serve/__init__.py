"""Serving frontend: the query tier in front of the index (port of
``repro.serve``).

The stack, bottom-up (each layer usable on its own):

  * :mod:`repro_torch.serve.cache`     -- ``LRUQueryCache``: generation-keyed
    host LRU of hot query results.
  * :mod:`repro_torch.serve.service`   -- ``StreamingNGramService``:
    generational index + cache behind a batch lookup / top-k / ingest API,
    plus ``microbatch_drive`` and ``make_query_stream`` (the synthetic-workload
    helpers the drivers share).
  * :mod:`repro_torch.serve.batcher`   -- ``ContinuousBatcher``: queue-fed
    coalescing of concurrent requests into fixed-shape device batches
    (padding buckets, deadline-based flush, double-buffered submit/collect).
  * :mod:`repro_torch.serve.admission` -- priority classes, per-tenant
    token-bucket quotas, queue-depth load shedding.
  * :mod:`repro_torch.serve.frontend`  -- ``QueryFrontend``: admission +
    in-flight duplicate coalescing + batcher glued onto one service.
  * :mod:`repro_torch.serve.http`      -- stdlib HTTP/SSE transport
    (point-lookup, top-k, streaming completion, topology/health).

The service runs on the card unless given ``device="cpu"``; the layers above
it touch no device themselves, and only the batcher's flush thread calls
into the service.  Everything re-exported here is lazy (PEP 562), as in
``repro``: importing the package imports none of its layers.
"""
from __future__ import annotations

__all__ = [
    "LRUQueryCache", "StreamingNGramService", "microbatch_drive",
    "make_query_stream", "ContinuousBatcher", "Request", "select_bucket",
    "TokenBucket", "AdmissionController", "QueryFrontend",
    "NGramHTTPServer", "serve_http",
]

_LAZY = {
    "LRUQueryCache": ("repro_torch.serve.cache", "LRUQueryCache"),
    "StreamingNGramService": ("repro_torch.serve.service", "StreamingNGramService"),
    "microbatch_drive": ("repro_torch.serve.service", "microbatch_drive"),
    "make_query_stream": ("repro_torch.serve.service", "make_query_stream"),
    "ContinuousBatcher": ("repro_torch.serve.batcher", "ContinuousBatcher"),
    "Request": ("repro_torch.serve.batcher", "Request"),
    "select_bucket": ("repro_torch.serve.batcher", "select_bucket"),
    "TokenBucket": ("repro_torch.serve.admission", "TokenBucket"),
    "AdmissionController": ("repro_torch.serve.admission", "AdmissionController"),
    "QueryFrontend": ("repro_torch.serve.frontend", "QueryFrontend"),
    "NGramHTTPServer": ("repro_torch.serve.http", "NGramHTTPServer"),
    "serve_http": ("repro_torch.serve.http", "serve_http"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return sorted(__all__)
