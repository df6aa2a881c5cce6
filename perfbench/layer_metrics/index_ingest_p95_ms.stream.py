"""index_ingest_p95_ms.stream: the 95th percentile over the window's deltas
of the milliseconds the generational index takes to take a delta in (freeze
and compaction), the service's own ``ingest_s`` in its ingest report."""
import numpy as np

LAYER = "generational index (index/merge, index/compress)"
UNIT = "ms"
MOVES = "delta_p95_ms"
SOURCE = "program_span"


def value(record):
    steps = record.get("steps") or []
    return float(np.percentile([s["ingest_s"] for s in steps], 95)) * 1e3 if steps else None
