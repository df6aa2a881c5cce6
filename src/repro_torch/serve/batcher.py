"""Continuous batcher: concurrent requests -> fixed-shape device batches
(port of ``repro.serve.batcher``).

The device side of the serving stack wants what ``microbatch_drive`` fakes:
fixed-shape batches arriving back to back.  Real traffic is single queries
landing on many transport threads.  The batcher sits between them:

  * requests enqueue into per-(priority, kind, k) FIFO lanes; the flush loop
    always picks the highest-priority lane with the oldest head request;
  * a flush takes up to the largest **padding bucket** of live requests and
    pads the batch up to the smallest bucket that holds them
    (:func:`select_bucket`) -- a handful of static shapes keeps the compiled
    program cache small while partial batches stay cheap;
  * a partially filled bucket flushes when its oldest request has waited
    ``deadline_s`` -- the wait is a condition-variable sleep with a computed
    timeout, never a poll loop (``stats()["wait_cycles"]`` stays O(flushes),
    regression-tested);
  * flushes ride the service's split submit/collect discipline (the same
    double-buffered contract as ``DoubleBufferedDriver`` /
    ``StreamingNGramService._submit_lookup``): batch i+1 is dispatched before
    batch i's device result is materialized, so queue drain and host delivery
    overlap device execution;
  * a cancelled (or admission-shed) request is dropped at pop time and
    **never occupies a padded slot in a live device batch** -- the batch is
    built from live requests only, and the bucket is chosen after the filter.

The batcher knows nothing about HTTP, admission, or the device: it drives an
``executor`` object with two methods::

    rec  = executor.submit(kind, k, grams, lengths)   # async dispatch
    rows = executor.collect(rec)                      # materialize [B(, R)]

``repro_torch.serve.frontend.ServiceExecutor`` adapts
``StreamingNGramService``; tests drive plain recording stubs.  With the
flush thread running, ``submit`` and ``collect`` of every batch run on that
one thread, so a batch's device work is launched and read back on the same
thread and stream (``stop`` drains on it too); in manual mode (no thread)
they run on the caller's.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["Request", "ContinuousBatcher", "select_bucket",
           "DEFAULT_BUCKETS", "FILL_BOUNDARIES"]

#: default padding-bucket ladder (slots per device batch)
DEFAULT_BUCKETS = (16, 64, 256)

#: fill-ratio histogram edges (fractions of the chosen bucket)
FILL_BOUNDARIES = tuple(i / 16 for i in range(1, 17))


def select_bucket(n_live: int, buckets) -> int:
    """Smallest padding bucket holding ``n_live`` rows (deterministic).

    The largest bucket caps the batch size -- the flush loop never pops more
    than ``buckets[-1]`` live requests, so the cap is always sufficient.
    """
    if n_live < 1:
        raise ValueError("a flush needs at least one live request")
    for b in buckets:
        if n_live <= b:
            return b
    return buckets[-1]


class Request:
    """One admitted query: its slot key, payload future, and coalesced riders.

    ``future`` resolves to the request's payload row (an int64 scalar of a
    uint32 count for lookups, the packed ``[2+2k]`` int64 continuation row
    for top-k: the service's dtypes).  Duplicate
    in-flight queries attach follower futures via :meth:`attach`; delivery
    fans the *same* payload object out to all of them, so coalesced answers
    are bit-identical by construction.
    """

    __slots__ = ("kind", "gram", "length", "k", "tenant", "priority", "key",
                 "future", "followers", "seq", "t_enqueue", "cancelled",
                 "_sealed", "_rlock")

    def __init__(self, kind: str, gram, length: int, *, k: int = 8,
                 tenant: str = "default", priority: int = 0, key=None):
        if kind not in ("lookup", "topk"):
            raise ValueError(f"unknown request kind {kind!r}")
        self.kind = kind
        self.gram = gram
        self.length = int(length)
        self.k = int(k)
        self.tenant = tenant
        self.priority = int(priority)
        self.key = key
        self.future: Future = Future()
        self.followers: list[Future] = []
        self.seq = -1
        self.t_enqueue = 0.0
        self.cancelled = False
        self._sealed = False
        self._rlock = threading.Lock()

    def attach(self, future: Future) -> bool:
        """Ride this request's answer; False once delivery already started."""
        with self._rlock:
            if self._sealed or self.cancelled:
                return False
            self.followers.append(future)
            return True

    def cancel(self) -> bool:
        """Drop the request before it reaches a device batch.

        Refused when followers already ride it (they still need the payload)
        or when delivery has begun.  A cancelled request is skipped at flush
        time -- it never pads a live batch.
        """
        with self._rlock:
            if self._sealed or self.followers:
                return False
            if not self.future.cancel():
                return False
            self.cancelled = True
            return True

    def deliver(self, payload=None, error: BaseException | None = None) -> None:
        with self._rlock:
            self._sealed = True
            targets = [self.future, *self.followers]
        for f in targets:
            try:
                if error is not None:
                    f.set_exception(error)
                else:
                    f.set_result(payload)
            except InvalidStateError:
                pass                      # racing cancel: nobody is waiting


class ContinuousBatcher:
    """Queue-fed flush loop coalescing requests into padded device batches.

    ``autostart=False`` skips the background thread; tests then drive
    :meth:`flush_once` / :meth:`collect_inflight` deterministically.  The
    injectable ``clock`` feeds deadlines and latency accounting.
    """

    def __init__(self, executor, *, buckets=DEFAULT_BUCKETS,
                 deadline_s: float = 2e-3, clock=time.perf_counter,
                 autostart: bool = True):
        b = tuple(sorted(int(x) for x in buckets))
        if not b or b[0] < 1 or len(set(b)) != len(b):
            raise ValueError("buckets must be distinct positive sizes")
        self.executor = executor
        self.buckets = b
        self.deadline_s = float(deadline_s)
        self.clock = clock
        self._cond = threading.Condition()
        self._lanes: dict[tuple, deque] = {}
        self._depth = 0
        self._seq = itertools.count()
        self._inflight = None            # (rec, batch, bucket) | None
        self._alive = True
        self._stats = {"batches": 0, "requests": 0, "wait_cycles": 0,
                       "cancelled_dropped": 0, "padded_slots": 0}
        self._thread = None
        if autostart:
            self._thread = threading.Thread(target=self._loop,
                                            name="repro_torch-batcher", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- producers

    @property
    def depth(self) -> int:
        """Queued (not yet flushed) requests -- the admission layer's signal."""
        return self._depth

    def enqueue(self, req: Request) -> None:
        with self._cond:
            if not self._alive:
                raise RuntimeError("batcher is stopped")
            req.seq = next(self._seq)
            req.t_enqueue = self.clock()
            lane = (req.priority, req.kind, req.k)
            q = self._lanes.get(lane)
            if q is None:
                q = self._lanes[lane] = deque()
            q.append(req)
            self._depth += 1
            obs_metrics.get_registry().gauge("frontend.queue_depth").set(
                self._depth)
            self._cond.notify()

    def stop(self) -> None:
        """Flush every queued request, drain the in-flight batch, join."""
        with self._cond:
            self._alive = False
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        else:                            # manual mode: drain synchronously
            while self.flush_once(force=True) is not None:
                pass
            self.collect_inflight()

    def stats(self) -> dict:
        with self._cond:
            return dict(self._stats, depth=self._depth)

    # ------------------------------------------------------------ flush loop

    def _prune_and_peek(self):
        """(lane, head, n_queued) of the best lane, dropping cancelled heads.

        Best = lowest priority level, then oldest head request.  Caller holds
        the lock.
        """
        best = None
        for lane, q in self._lanes.items():
            while q and q[0].cancelled:
                q.popleft()
                self._depth -= 1
                self._stats["cancelled_dropped"] += 1
            if not q:
                continue
            cand = (lane[0], q[0].seq)
            if best is None or cand < best[0]:
                best = (cand, lane, q[0], len(q))
        if best is None:
            return None
        return best[1], best[2], best[3]

    def _pop_batch(self, lane) -> list:
        """Up to ``buckets[-1]`` live requests off one lane; caller holds lock.

        Cancelled requests are dropped here -- after this filter the batch
        holds live requests only, so no shed/cancelled slot is ever padded
        into the device batch.
        """
        q = self._lanes[lane]
        batch: list = []
        while q and len(batch) < self.buckets[-1]:
            req = q.popleft()
            self._depth -= 1
            if req.cancelled:
                self._stats["cancelled_dropped"] += 1
                continue
            batch.append(req)
        obs_metrics.get_registry().gauge("frontend.queue_depth").set(
            self._depth)
        return batch

    def _next_action(self):
        """Block until there is work: ("flush", batch) | ("drain", None) | None.

        The deadline wait is ``Condition.wait(timeout)`` -- new arrivals
        notify, the timeout fires the partial-bucket flush, and nothing spins.
        """
        with self._cond:
            while True:
                choice = self._prune_and_peek()
                if choice is None:
                    if self._inflight is not None:
                        return "drain", None
                    if not self._alive:
                        return None
                    self._cond.wait()
                    continue
                lane, head, n_queued = choice
                now = self.clock()
                due = head.t_enqueue + self.deadline_s
                if (n_queued >= self.buckets[-1] or now >= due
                        or not self._alive):
                    batch = self._pop_batch(lane)
                    if not batch:        # every queued request was cancelled
                        continue
                    return "flush", batch
                if self._inflight is not None:
                    # collect the dispatched batch while this one's deadline
                    # accrues: delivery overlaps the queue fill
                    return "drain", None
                self._stats["wait_cycles"] += 1
                self._cond.wait(max(due - now, 0.0))

    def _loop(self) -> None:
        while True:
            action = self._next_action()
            if action is None:
                return
            op, batch = action
            if op == "flush":
                self._dispatch(batch)
            else:
                self.collect_inflight()

    # -------------------------------------------------------- dispatch side

    def _dispatch(self, batch: list) -> None:
        """Pad live requests into a bucket and dispatch; collect the previous
        in-flight batch afterwards (the double-buffered submit/collect order:
        device work on this batch overlaps host delivery of the last one)."""
        kind, k = batch[0].kind, batch[0].k
        m = len(batch)
        bucket = select_bucket(m, self.buckets)
        width = int(np.asarray(batch[0].gram).shape[0])
        grams = np.zeros((bucket, width), np.int32)
        lengths = np.zeros((bucket,), np.int32)
        for i, req in enumerate(batch):
            grams[i] = req.gram
            lengths[i] = req.length
        reg = obs_metrics.get_registry()
        reg.counter("frontend.batches").add(1)
        reg.histogram("frontend.batch_fill", FILL_BOUNDARIES).observe(
            m / bucket)
        with self._cond:
            self._stats["batches"] += 1
            self._stats["requests"] += m
            self._stats["padded_slots"] += bucket - m
        with obs_trace.span("serve.flush") as sp:
            if sp:
                sp.set(kind=kind, live=m, bucket=bucket)
            try:
                rec = self.executor.submit(kind, k, grams, lengths)
            except Exception as e:       # deliver, keep the loop alive
                for req in batch:
                    req.deliver(error=e)
                return
        prev, self._inflight = self._inflight, (rec, batch)
        if prev is not None:
            self._collect(prev)

    def _collect(self, entry) -> None:
        rec, batch = entry
        try:
            rows = self.executor.collect(rec)
        except Exception as e:
            for req in batch:
                req.deliver(error=e)
            return
        for i, req in enumerate(batch):
            req.deliver(rows[i])

    def collect_inflight(self) -> None:
        """Materialize and deliver the in-flight batch, if any."""
        entry, self._inflight = self._inflight, None
        if entry is not None:
            self._collect(entry)

    # ------------------------------------------------------ manual test mode

    def flush_once(self, *, force: bool = False):
        """One deterministic flush step (manual mode): the batch popped, or
        ``None`` when nothing is due.  ``force=True`` ignores deadline/fill."""
        with self._cond:
            choice = self._prune_and_peek()
            if choice is None:
                return None
            lane, head, n_queued = choice
            due = head.t_enqueue + self.deadline_s
            if not (force or n_queued >= self.buckets[-1]
                    or self.clock() >= due):
                return None
            batch = self._pop_batch(lane)
        if not batch:
            return None
        self._dispatch(batch)
        return batch
