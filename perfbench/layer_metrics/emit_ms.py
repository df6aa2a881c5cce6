"""emit_ms: milliseconds a job spends in the map emit, the program's
``round.emit`` spans (synchronized at their close) inside each ``plan.run``,
median over the window's jobs."""
import statistics

from perfbench.spans import per_root

LAYER = "executor (pipeline/executor.run_plan)"
UNIT = "ms"
MOVES = "job_terms_per_s"
SOURCE = "program_span"


def value(record):
    jobs = per_root(record.get("spans") or [], "plan.run", ("round.emit",))
    return statistics.median(inside for _, inside in jobs) if jobs else None
