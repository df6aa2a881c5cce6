"""stages_ms: milliseconds a job spends in combine, partition, sort and
reduce, the program's ``round.stages`` spans (synchronized at their close)
inside each ``plan.run``, median over the window's jobs."""
import statistics

from perfbench.spans import per_root

LAYER = "executor (pipeline/executor.run_plan)"
UNIT = "ms"
MOVES = "job_terms_per_s"
SOURCE = "program_span"


def value(record):
    jobs = per_root(record.get("spans") or [], "plan.run", ("round.stages",))
    return statistics.median(inside for _, inside in jobs) if jobs else None
