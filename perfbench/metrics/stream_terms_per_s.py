"""stream_terms_per_s: the non-PAD terms of the deltas ingested in the
window, over the window's seconds; the query batches after each delta are
part of the window (host clock)."""
SOURCE = "host_clock"


def value(record):
    steps = record.get("steps")
    if not steps or "latency_s" not in steps[0]:
        return None
    return sum(s["terms"] for s in steps) / record["window_s"]
