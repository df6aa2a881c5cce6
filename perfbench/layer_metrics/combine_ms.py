"""combine_ms: milliseconds a job spends in the stage core's combine, the
program's ``stage.combine`` spans (synchronized at their close) inside each
``plan.run``, median over the window's jobs."""
from perfbench.span_groups import job_median_ms

LAYER = "stage core (pipeline/executor._stage_core_impl)"
UNIT = "ms"
MOVES = "job_terms_per_s"
SOURCE = "program_span"


def value(record):
    return job_median_ms(record.get("spans") or [], "stage.combine")
