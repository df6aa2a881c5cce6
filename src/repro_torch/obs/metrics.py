"""The job-counter type policy (main-path part of ``repro.obs.metrics``).

``NGramStats.counters`` is a plain dict of the paper's Hadoop-counter
analogues; :func:`normalize_counters` pins their types -- ints for counts,
floats for the ratio keys -- so the port's dict equals ``repro``'s exactly.
"""
from __future__ import annotations

__all__ = ["FLOAT_COUNTERS", "normalize_counters"]

#: Keys whose values are ratios (kept float); everything else is a count.
FLOAT_COUNTERS = frozenset({"shuffle_skew"})


def normalize_counters(counters: dict) -> dict:
    """Pin counter value types: ints for counts, floats for ratio keys."""
    return {k: float(v) if k in FLOAT_COUNTERS else int(v)
            for k, v in counters.items()}
