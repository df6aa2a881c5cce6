"""Typed metrics: counters, gauges, fixed-boundary histograms, counter policy
(port of ``repro.obs.metrics``; it touches no device).

Two things live here:

1. A :class:`MetricsRegistry` of typed instruments.  Counters accumulate,
   gauges hold the latest value, histograms bucket observations against fixed
   boundaries so p50/p95/p99 come out of bucket interpolation with **no sample
   storage**.  ``registry.snapshot()`` is plain JSON-able data;
   ``repro_torch.obs.report`` renders and validates it.

2. The **canonical job-counter glossary** (:data:`COUNTER_DOC`, the same keys
   as ``repro``'s) and its merge policy: :func:`merge_counter_dicts` is the
   shared fold (sums, except ``max``-merged keys like ``shuffle_skew``), and
   :func:`normalize_counters` pins the types (ints for counts, float for
   ratios), so the port's ``NGramStats.counters`` equals ``repro``'s exactly.

The disabled path is a shared null singleton (:data:`null_registry`):
instruments exist, every mutation is a no-op, nothing is allocated.
"""
from __future__ import annotations

import math

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "COUNTER_DOC", "MAX_MERGED_COUNTERS", "FLOAT_COUNTERS",
           "merge_counter_dicts", "normalize_counters",
           "get_registry", "set_registry", "null_registry",
           "default_latency_boundaries"]


# --------------------------------------------------------------------------- #
# canonical job-counter set (the paper's Hadoop-counter analogues)
# --------------------------------------------------------------------------- #

#: Every counter the job/wave/serving paths may emit, in one place.  The
#: monolithic path (``pipeline.executor.run_plan``) and the wave path
#: (``WaveExecutor.run``) emit the same names with the same meanings; keys
#: marked *wave-only* exist only where the concept does.
COUNTER_DOC: dict[str, str] = {
    "jobs": "MapReduce jobs (= stage-pipeline rounds) executed",
    "map_records": "records emitted by the map phase, pre-combine "
                   "(MAP_OUTPUT_RECORDS)",
    "shuffle_records": "records entering the shuffle, post-combine "
                       "(REDUCE_INPUT_RECORDS)",
    "shuffle_bytes": "shuffled records x packed record bytes "
                     "(MAP_OUTPUT_BYTES)",
    "shuffle_skew": "max realized reducer load / mean, over nominal "
                    "reducers (float; folds by max, not sum).  On the fused "
                    "mesh-wave path the histogram collective behind it only "
                    "runs when metrics are enabled -- disabled runs report "
                    "0.0 and skip the psum entirely",
    "retries": "capacity-doubling shuffle reruns (mesh waves rerun the WHOLE "
               "fused wave at doubled capacity scale, sharded serving reruns "
               "the query batch); 0 on paths with exact-sized buffers",
    "overflow": "records dropped for capacity (always 0 -- overflow "
                "triggers a retry instead; kept as the loud invariant)",
    "waves": "token waves executed (wave-only)",
    "fold_rows": "segment rows fed through merge_segments by the wave "
                 "accumulator -- the measured fold work (wave-only)",
    "phase_b_records": "SUFFIX-sigma phase-B survivor records (method-only)",
    "post_filter_jobs": "maximality/closedness post-filter jobs (method-only)",
    # ---- serving-frontend instruments (repro_torch.serve; registry names,
    # not job counters -- they never ride NGramStats.counters or the merge
    # policy).  Companion histograms: frontend.batch_fill (live slots /
    # padded bucket), frontend.ttfb_seconds (admission -> payload
    # available); gauge: frontend.queue_depth.  Spans: serve.request
    # (transport thread) and serve.flush (batcher thread).
    #
    # The generational index publishes gen.* gauges and counters
    # (GenerationalIndex._publish_metrics) and the compressed decode
    # merge.blocks_decoded / compress.rows_decoded, under repro's names and
    # at repro's points.  Every value equals repro's but one kind:
    # gen.rung{i}_bytes_at_rest and gen.bytes_at_rest count a flat (or not
    # yet materialized) rung at the port's resident bytes, whose packed lanes
    # and counts are int64 -- about twice repro's uint32 bytes.  A compressed
    # rung counts its persisted streams, which equal repro's byte for byte.
    "frontend.requests": "queries offered to the frontend, pre-admission",
    "frontend.shed": "requests rejected by queue-depth load shedding "
                     "(HTTP 503): past the soft budget only the top "
                     "priority class is admitted, past the hard limit "
                     "nothing is",
    "frontend.quota_rejected": "requests rejected by a tenant's token "
                               "bucket (HTTP 429)",
    "frontend.coalesced": "duplicate in-flight queries welded onto an "
                          "already-admitted request's answer (same key as "
                          "the LRU cache + index generation); they occupy "
                          "no batch slot and pay no quota",
    "frontend.batches": "device batches flushed by the continuous batcher "
                        "(full bucket or deadline)",
}

#: Keys that fold by ``max`` across waves instead of summing: a ratio like
#: the shuffle skew is meaningless summed, and the worst wave is the report.
MAX_MERGED_COUNTERS = frozenset({"shuffle_skew"})

#: Keys whose values are ratios (kept float); everything else is a count.
FLOAT_COUNTERS = frozenset({"shuffle_skew"})


def merge_counter_dicts(dst: dict, src: dict) -> dict:
    """Fold ``src`` counters into ``dst`` in place: sums, except the
    :data:`MAX_MERGED_COUNTERS` keys, which fold by ``max``."""
    for key, v in src.items():
        if key in MAX_MERGED_COUNTERS:
            dst[key] = max(dst.get(key, 0.0), float(v))
        else:
            dst[key] = dst.get(key, 0) + v
    return dst


def normalize_counters(counters: dict) -> dict:
    """Pin counter value types: ints for counts, floats for ratio keys."""
    return {k: float(v) if k in FLOAT_COUNTERS else int(v)
            for k, v in counters.items()}


# --------------------------------------------------------------------------- #
# typed instruments
# --------------------------------------------------------------------------- #

class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def add(self, v=1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


class Gauge:
    """Latest-value instrument (queue depth, segment count, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def add(self, v=1) -> None:
        self.value += v

    def snapshot(self):
        return self.value


def default_latency_boundaries() -> tuple[float, ...]:
    """Geometric bucket edges 1us..100s (4 per decade): latency seconds."""
    return tuple(10.0 ** (-6 + i / 4) for i in range(33))


class Histogram:
    """Fixed-boundary histogram: quantiles without sample storage.

    ``boundaries`` are the B sorted bucket edges; observations land in B+1
    buckets (``(-inf, b0], (b0, b1], ..., (b_{B-1}, inf)``).  ``quantile(q)``
    walks the cumulative counts to the target bucket and interpolates
    linearly inside it, clamping the open-ended end buckets to the observed
    min/max -- so the estimate is exact to within one bucket's width
    (differentially tested against the numpy sample oracle).
    """

    __slots__ = ("name", "boundaries", "counts", "count", "sum", "min", "max")

    def __init__(self, name: str, boundaries=None):
        if boundaries is None:
            boundaries = default_latency_boundaries()
        b = tuple(float(x) for x in boundaries)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError("histogram boundaries must be strictly increasing")
        if not b:
            raise ValueError("histogram needs at least one boundary")
        self.name = name
        self.boundaries = b
        self.counts = [0] * (len(b) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v) -> None:
        v = float(v)
        lo, hi = 0, len(self.boundaries)
        while lo < hi:                      # first boundary >= v
            mid = (lo + hi) // 2
            if self.boundaries[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                # bucket i spans (lo_edge, hi_edge]; clamp open ends to the
                # observed extrema so tail quantiles stay finite
                lo_edge = self.boundaries[i - 1] if i > 0 else self.min
                hi_edge = self.boundaries[i] if i < len(self.boundaries) \
                    else self.max
                lo_edge = max(lo_edge, self.min)
                hi_edge = min(hi_edge, self.max)
                frac = (target - cum) / c
                return lo_edge + (hi_edge - lo_edge) * frac
            cum += c
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "boundaries": list(self.boundaries),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Named typed instruments + the job-counter compatibility bridge."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def __bool__(self) -> bool:
        return True

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, boundaries=None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, boundaries)
        return h

    def merge_job_counters(self, counters: dict, prefix: str = "job.") -> None:
        """Absorb an ``NGramStats.counters`` dict under the shared policy."""
        for k, v in normalize_counters(counters).items():
            if k in MAX_MERGED_COUNTERS:
                g = self.gauge(prefix + k)
                g.set(max(float(g.value), v))
            else:
                self.counter(prefix + k).add(v)

    @property
    def counters(self) -> dict:
        """Plain dict view of counter values (the ad-hoc-dict-shaped read)."""
        return {k: c.value for k, c in self._counters.items()}

    def snapshot(self) -> dict:
        """JSON-able state: the unit ``report.write_jsonl`` records."""
        return {
            "counters": {k: c.snapshot() for k, c in
                         sorted(self._counters.items())},
            "gauges": {k: g.snapshot() for k, g in
                       sorted(self._gauges.items())},
            "histograms": {k: h.snapshot() for k, h in
                           sorted(self._histograms.items())},
        }


class _NullInstrument:
    """Shared do-nothing counter/gauge/histogram."""

    __slots__ = ()
    name = "null"
    value = 0
    count = 0

    def add(self, v=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


class _NullRegistry:
    """Disabled-path registry: every instrument is the shared null singleton."""

    __slots__ = ()
    _NULL = _NullInstrument()

    def __bool__(self) -> bool:
        return False

    def counter(self, name: str):
        return self._NULL

    def gauge(self, name: str):
        return self._NULL

    def histogram(self, name: str, boundaries=None):
        return self._NULL

    def merge_job_counters(self, counters: dict, prefix: str = "job.") -> None:
        pass


null_registry = _NullRegistry()

_REGISTRY = null_registry


def set_registry(reg) -> None:
    """Install the active registry (``None`` / ``null_registry`` disables)."""
    global _REGISTRY
    _REGISTRY = reg if reg is not None else null_registry


def get_registry():
    """The active registry, or the shared null singleton when disabled.

    Instrumented code calls this unconditionally; the disabled cost is one
    global read plus no-op method calls -- no allocation, no sync.
    """
    return _REGISTRY
