"""canonical_stats_ms: milliseconds of a job's host finish, the program's
``stages.canonical`` span around ``stages.canonical_stats`` (the lexsort of
the output rows) inside each ``plan.run``, median over the window's jobs."""
from perfbench.span_groups import job_median_ms

LAYER = "stages, host (pipeline/stages.canonical_stats)"
UNIT = "ms"
MOVES = "job_terms_per_s"
SOURCE = "program_span"


def value(record):
    return job_median_ms(record.get("spans") or [], "stages.canonical")
