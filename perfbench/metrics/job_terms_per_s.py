"""job_terms_per_s: the non-PAD corpus terms of every job completed in the
window, over the window's seconds (host clock; each job ends with its output
on the host)."""
SOURCE = "host_clock"


def value(record):
    steps = record.get("steps")
    if not steps or "s" not in steps[0]:
        return None
    return sum(s["terms"] for s in steps) / record["window_s"]
