"""delta_p95_ms: the 95th percentile, over every delta of the window, of the
milliseconds from the delta's ``ingest`` call to the return of the first
lookup batch after it (host clock; linear interpolation between ranks)."""
import numpy as np

SOURCE = "host_clock"


def value(record):
    steps = record.get("steps")
    if not steps or "latency_s" not in steps[0]:
        return None
    return float(np.percentile([s["latency_s"] for s in steps], 95)) * 1e3
