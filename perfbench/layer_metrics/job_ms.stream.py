"""job_ms.stream: milliseconds of the n-gram job over one delta, the
service's own ``job_s`` in its ingest report, median over the window's
deltas."""
import statistics

LAYER = "service (serve/service.StreamingNGramService)"
UNIT = "ms"
MOVES = "stream_terms_per_s"
SOURCE = "program_span"


def value(record):
    steps = record.get("steps") or []
    return statistics.median(s["job_s"] for s in steps) * 1e3 if steps else None
