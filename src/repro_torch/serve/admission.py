"""Admission control: priority classes, tenant quotas, load shedding
(port of ``repro.serve.admission``; pure policy, no device).

The layer in front of the batcher queue.  Policy, in verdict order:

1. **Load shedding by queue depth.**  ``queue_budget`` is the soft budget:
   past it, only the highest priority class (level 0) is admitted; past the
   ``hard_limit`` everything sheds.  Shedding keeps the queue -- and therefore
   time-to-first-byte of admitted requests -- bounded under overload: offered
   load beyond capacity turns into fast 503s, not latency collapse.
2. **Per-tenant token buckets.**  Each tenant refills at ``quota_rate``
   requests/second up to ``quota_burst``; an empty bucket is a quota
   rejection (HTTP 429), independent of system load.  Shedding is checked
   first so an overloaded system does not silently burn tenant tokens.

The controller is pure policy: it returns verdicts and never touches queues
or counters itself (the frontend owns those side effects), so every decision
path is deterministic under an injected clock.
"""
from __future__ import annotations

import time

__all__ = ["TokenBucket", "AdmissionController", "PRIORITIES",
           "ADMIT", "SHED", "QUOTA"]

#: priority classes, lower level = more important; level 0 survives the soft
#: budget (the "interactive" tier of the two-class serving convention)
PRIORITIES: dict[str, int] = {"interactive": 0, "batch": 1}

ADMIT = "admit"
SHED = "shed"
QUOTA = "quota"


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity."""

    __slots__ = ("rate", "burst", "tokens", "_clock", "_last")

    def __init__(self, rate: float, burst: float, *, clock=time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._clock = clock
        self._last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        now = self._clock()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """Verdict machine for one frontend queue.

    ``quota_rate=None`` disables tenant quotas entirely (every tenant
    unlimited); ``hard_limit`` defaults to four soft budgets.
    """

    def __init__(self, *, queue_budget: int = 512, hard_limit: int | None = None,
                 quota_rate: float | None = None, quota_burst: float | None = None,
                 priorities: dict[str, int] | None = None, clock=time.monotonic):
        if queue_budget < 0:
            raise ValueError("queue_budget must be >= 0")
        self.queue_budget = int(queue_budget)
        self.hard_limit = int(4 * queue_budget if hard_limit is None
                              else hard_limit)
        if self.hard_limit < self.queue_budget:
            raise ValueError("hard_limit must be >= queue_budget")
        self.quota_rate = quota_rate
        self.quota_burst = quota_burst if quota_burst is not None else \
            (2 * quota_rate if quota_rate is not None else None)
        self.priorities = dict(PRIORITIES if priorities is None else priorities)
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}

    def level(self, priority: str) -> int:
        """Numeric level of a priority class name (KeyError on unknown)."""
        return self.priorities[priority]

    def bucket(self, tenant: str) -> TokenBucket | None:
        if self.quota_rate is None:
            return None
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TokenBucket(
                self.quota_rate, self.quota_burst, clock=self._clock)
        return b

    def admit(self, *, tenant: str, level: int, queue_depth: int) -> str:
        """One verdict: :data:`ADMIT`, :data:`SHED`, or :data:`QUOTA`."""
        if queue_depth >= self.hard_limit:
            return SHED
        if queue_depth >= self.queue_budget and level > 0:
            return SHED
        b = self.bucket(tenant)
        if b is not None and not b.try_take():
            return QUOTA
        return ADMIT

    def describe(self) -> dict:
        """JSON-able config summary for the topology endpoint."""
        return {"queue_budget": self.queue_budget,
                "hard_limit": self.hard_limit,
                "quota_rate": self.quota_rate,
                "quota_burst": self.quota_burst,
                "priorities": dict(self.priorities)}
