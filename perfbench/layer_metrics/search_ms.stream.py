"""search_ms.stream: milliseconds a delta's queries spend taking the cache's
misses to the index and their answers back (copies, searches, readback),
the program's ``svc.search`` spans of the delta less the ``gen.materialize``
spans inside them (a rung built at its first read), median over the
window's deltas."""
import statistics

from perfbench.span_groups import inside, per_delta

LAYER = "index query (index/query)"
UNIT = "ms"
MOVES = "delta_p95_ms"
SOURCE = "program_span"


def _search_us(delta: list) -> float:
    searches = [e for e in delta if e["name"] == "svc.search"]
    built = [e for e in delta if e["name"] == "gen.materialize"
             and any(inside(e, s) for s in searches)]
    return sum(e["dur"] for e in searches) - sum(e["dur"] for e in built)


def value(record):
    spans = record.get("spans") or []
    if not any(e["name"] == "svc.search" for e in spans):
        return None
    return statistics.median(_search_us(d) / 1e3 for d in per_delta(spans))
