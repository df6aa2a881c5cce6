"""cache_ms.stream: milliseconds a delta's queries spend building cache keys
and consulting and filling the query cache, the program's ``svc.cache``
spans of the delta summed, median over the window's deltas."""
import statistics

from perfbench.span_groups import per_delta

LAYER = "service (serve/service.StreamingNGramService)"
UNIT = "ms"
MOVES = "stream_terms_per_s"
SOURCE = "program_span"


def value(record):
    spans = record.get("spans") or []
    if not any(e["name"] == "svc.cache" for e in spans):
        return None
    return statistics.median(sum(e["dur"] for e in d if e["name"] == "svc.cache") / 1e3
                             for d in per_delta(spans))
