"""query_ms.stream: milliseconds of one lookup batch and the continuation
batch after it, from the end of the delta's ingest to the return of the
continuations (host clock), median over the window's deltas."""
import statistics

LAYER = "service (serve/service.StreamingNGramService)"
UNIT = "ms"
MOVES = "stream_terms_per_s"
SOURCE = "host_clock"


def value(record):
    steps = record.get("steps") or []
    return statistics.median(s["query_s"] for s in steps) * 1e3 if steps else None
