"""QueryFrontend: admission + duplicate coalescing + batcher on one service
(port of ``repro.serve.frontend``).

The request-level API every transport shares (the HTTP handler, the open-loop
benchmark driver, the tests):

    frontend = QueryFrontend(service)
    ticket = frontend.submit("lookup", gram, length, tenant="t0",
                             priority="interactive")
    if ticket.admitted:
        payload = ticket.future.result()

``submit`` is non-blocking: it runs the admission verdict, coalesces
duplicate in-flight queries (keyed exactly like the LRU cache, plus the index
generation so an ingest swap never welds new queries onto stale answers), and
enqueues into the continuous batcher.  ``call`` / ``call_many`` are the
blocking conveniences that also record the ``serve.request`` span and the
time-to-first-byte histogram.

Observability (all under the active registry; names in
``repro_torch.obs.metrics.COUNTER_DOC``):

  counters   frontend.requests / frontend.shed / frontend.quota_rejected /
             frontend.coalesced / frontend.batches
  gauge      frontend.queue_depth
  histograms frontend.batch_fill, frontend.ttfb_seconds
  spans      serve.request (transport thread) over serve.flush ->
             the service's device dispatch (batcher thread)

Threads.  ``submit`` and ``call`` run on the transport's threads and touch
only host state (the admission verdict, the coalescing table, the batcher's
queue, the index's host generation counter); every device launch and
read-back happens on the batcher's flush thread, inside
``ServiceExecutor.submit`` / ``collect``.  ``topology`` reads only host
state too (:func:`repro_torch.index.serve.describe_topology`).

Payloads carry the service's dtypes: a lookup resolves to an int64 count, a
top-k request to an int64 ``[2+2k]`` row (``repro``'s are uint32), and the
trivial answers of over-long queries match them.  ``topology()["devices"]``
comes from ``torch.cuda`` (``backend`` is ``"cuda"`` when the process sees
a card, else ``"cpu"``; ``count`` the visible cards), where ``repro`` asks
JAX for its default backend.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from .admission import ADMIT, QUOTA, SHED, AdmissionController
from .batcher import ContinuousBatcher, Request

__all__ = ["QueryFrontend", "ServiceExecutor", "Ticket"]


class ServiceExecutor:
    """Adapt ``StreamingNGramService`` to the batcher's submit/collect pair.

    Lookups ride the service's double-buffered split (``_submit_lookup``
    launches the searches, ``_collect_lookup`` reads them back one batch
    later); top-k goes through ``continuations`` (cache-first, synchronous)
    and is handed over at collect time.
    """

    def __init__(self, service):
        self.service = service

    def submit(self, kind: str, k: int, grams, lengths):
        if kind == "lookup":
            return "lookup", self.service._submit_lookup(grams, lengths)
        return "topk", self.service.continuations(grams, lengths, k=k)

    def collect(self, rec):
        tag, payload = rec
        if tag == "lookup":
            return self.service._collect_lookup(payload)
        return payload


class Ticket:
    """Outcome of one ``submit``: the admission status + payload future."""

    __slots__ = ("status", "future", "request")

    def __init__(self, status: str, future: Future | None, request):
        self.status = status
        self.future = future
        self.request = request

    @property
    def admitted(self) -> bool:
        return self.future is not None


class QueryFrontend:
    """The serving tier in front of one :class:`StreamingNGramService`."""

    def __init__(self, service, *, admission: AdmissionController | None = None,
                 buckets=None, deadline_s: float = 2e-3,
                 clock=time.perf_counter, autostart: bool = True,
                 executor=None):
        self.service = service
        self.sigma = int(service.cfg.sigma)
        self.clock = clock
        self.admission = admission if admission is not None else \
            AdmissionController()
        kw = {} if buckets is None else {"buckets": buckets}
        self.batcher = ContinuousBatcher(
            executor if executor is not None else ServiceExecutor(service),
            deadline_s=deadline_s, clock=clock, autostart=autostart, **kw)
        self._lock = threading.Lock()
        self._inflight_keys: dict = {}

    # ------------------------------------------------------------ submission

    def _normalize(self, kind: str, gram, length: int | None, k: int):
        """Gram row [sigma] int32 + clamped length; None = trivially empty."""
        g = np.asarray(gram, np.int32).reshape(-1)
        n = int(g.shape[0]) if length is None else int(length)
        row = np.zeros((self.sigma,), np.int32)
        if n > (self.sigma if kind == "lookup" else self.sigma - 1):
            return None, n                # longer than the index holds: miss
        row[:n] = g[:n]
        row[n:] = 0
        return row, n

    def _trivial_payload(self, kind: str, k: int):
        if kind == "lookup":
            return np.int64(0)
        return np.zeros((2 + 2 * k,), np.int64)

    def submit(self, kind: str, gram, length: int | None = None, *, k: int = 8,
               tenant: str = "default", priority: str = "interactive") -> Ticket:
        """Admission verdict + (if admitted) an enqueued request ticket.

        ``status``: "admitted" | "coalesced" | "shed" | "quota".  Shed and
        quota tickets carry no future -- the caller maps them to 503/429.
        """
        reg = obs_metrics.get_registry()
        reg.counter("frontend.requests").add(1)
        level = self.admission.level(priority)
        row, n = self._normalize(kind, gram, length, k)
        if row is None:                   # out-of-range length: exact miss
            f: Future = Future()
            f.set_result(self._trivial_payload(kind, k))
            return Ticket("admitted", f, None)
        svc = self.service
        gen_id = svc.gen.generation
        key = (gen_id, svc.lookup_key(row, n)) if kind == "lookup" else \
            (gen_id, svc.continuation_key(row, n, k))
        with self._lock:
            primary = self._inflight_keys.get(key)
            if primary is not None:
                f = Future()
                if primary.attach(f):
                    reg.counter("frontend.coalesced").add(1)
                    return Ticket("coalesced", f, primary)
        verdict = self.admission.admit(tenant=tenant, level=level,
                                       queue_depth=self.batcher.depth)
        if verdict == QUOTA:
            reg.counter("frontend.quota_rejected").add(1)
            return Ticket("quota", None, None)
        if verdict == SHED:
            reg.counter("frontend.shed").add(1)
            return Ticket("shed", None, None)
        assert verdict == ADMIT
        req = Request(kind, row, n, k=k, tenant=tenant, priority=level,
                      key=key)
        with self._lock:
            self._inflight_keys[key] = req
        req.future.add_done_callback(
            lambda _f, key=key, req=req: self._forget(key, req))
        self.batcher.enqueue(req)
        return Ticket("admitted", req.future, req)

    def _forget(self, key, req) -> None:
        with self._lock:
            if self._inflight_keys.get(key) is req:
                del self._inflight_keys[key]

    # ------------------------------------------------------- blocking helpers

    def call(self, kind: str, gram, length: int | None = None, *, k: int = 8,
             tenant: str = "default", priority: str = "interactive",
             timeout: float | None = 30.0):
        """Blocking one-query path: (status, payload | None).

        Wraps the whole request in a ``serve.request`` span and records
        time-to-first-byte (admission -> payload available) into
        ``frontend.ttfb_seconds``.
        """
        with obs_trace.span("serve.request") as sp:
            t0 = self.clock()
            ticket = self.submit(kind, gram, length, k=k, tenant=tenant,
                                 priority=priority)
            if sp:
                sp.set(kind=kind, status=ticket.status, tenant=tenant)
            if not ticket.admitted:
                return ticket.status, None
            payload = ticket.future.result(timeout)
            obs_metrics.get_registry().histogram(
                "frontend.ttfb_seconds").observe(self.clock() - t0)
        return ticket.status, payload

    def call_many(self, kind: str, grams, lengths=None, *, k: int = 8,
                  tenant: str = "default", priority: str = "interactive",
                  timeout: float | None = 30.0):
        """Submit a client-side batch, then gather: (statuses, payloads).

        Rows that shed or hit quota report their status with a ``None``
        payload; admitted rows resolve in submission order.  The rows coalesce
        into device batches with every other in-flight request -- a client
        batch holds no special scheduling power.
        """
        grams = np.asarray(grams, np.int32)
        if lengths is None:
            lengths = [None] * grams.shape[0]
        tickets = [self.submit(kind, g, ln, k=k, tenant=tenant,
                               priority=priority)
                   for g, ln in zip(grams, lengths)]
        payloads = [t.future.result(timeout) if t.admitted else None
                    for t in tickets]
        return [t.status for t in tickets], payloads

    # ------------------------------------------------------------- lifecycle

    def topology(self) -> dict:
        """Shard/segment discovery + live frontend state (the HTTP endpoint)."""
        from repro_torch.index.serve import describe_topology
        svc = self.service
        info = {
            "service": {
                "sigma": self.sigma,
                "vocab_size": int(svc.cfg.vocab_size),
                "generation": int(svc.gen.generation),
            },
            "index": describe_topology(svc.gen),
            "cache": svc.cache.snapshot(),
            "batcher": dict(self.batcher.stats(),
                            buckets=list(self.batcher.buckets),
                            deadline_s=self.batcher.deadline_s),
            "admission": self.admission.describe(),
        }
        cuda = torch.cuda.is_available()
        info["devices"] = {"backend": "cuda" if cuda else "cpu",
                           "count": torch.cuda.device_count() if cuda else 0}
        return info

    def close(self) -> None:
        self.batcher.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
