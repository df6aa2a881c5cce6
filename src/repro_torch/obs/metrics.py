"""The job-counter policy (the counter parts of ``repro.obs.metrics``).

``NGramStats.counters`` is a plain dict of the paper's Hadoop-counter
analogues.  :func:`normalize_counters` pins their types -- ints for counts,
floats for the ratio keys -- so the port's dict equals ``repro``'s exactly;
:func:`merge_counter_dicts` folds one wave's counters into a run's, as the
wave engine does.
"""
from __future__ import annotations

__all__ = ["FLOAT_COUNTERS", "MAX_MERGED_COUNTERS", "merge_counter_dicts",
           "normalize_counters"]

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
