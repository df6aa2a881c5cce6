"""The program's spans grouped as the stage and service metrics read them:
by job (inside each ``plan.run``) and by delta (from one ``svc.ingest``'s
start to the next one's).  Spans are ``repro_torch.obs.trace`` events:
``name``, ``ts`` and ``dur`` in microseconds, ``args``.  A program whose
spans lack the name read gives None, not 0."""
from __future__ import annotations

import bisect
import statistics

from perfbench.spans import per_root

__all__ = ["job_median_ms", "per_delta", "inside"]


def job_median_ms(spans: list, name: str) -> float | None:
    """Milliseconds of the spans named ``name`` inside each ``plan.run``,
    median over the jobs; None without such a span."""
    if not any(e["name"] == name for e in spans):
        return None
    jobs = per_root(spans, "plan.run", (name,))
    return statistics.median(ms for _, ms in jobs) if jobs else None


def per_delta(spans: list) -> list[list]:
    """The spans of each delta, in the order of the deltas: those that start
    at or after its ``svc.ingest`` and before the next ``svc.ingest``."""
    starts = sorted(e["ts"] for e in spans if e["name"] == "svc.ingest")
    groups: list[list] = [[] for _ in starts]
    for e in spans:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            groups[i].append(e)
    return groups


def inside(e: dict, outer: dict) -> bool:
    """Span ``e`` lies within span ``outer``'s interval."""
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
