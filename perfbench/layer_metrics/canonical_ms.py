"""canonical_ms: milliseconds of a job's ``plan.run`` span outside its
``round.*`` spans: the host finish (``stages.canonical_stats``, the counters),
median over the window's jobs."""
import statistics

from perfbench.spans import per_root

LAYER = "stages, host (pipeline/stages.canonical_stats)"
UNIT = "ms"
MOVES = "job_terms_per_s"
SOURCE = "program_span"


def value(record):
    jobs = per_root(record.get("spans") or [], "plan.run",
                    ("round.emit", "round.stages", "round.materialize"))
    return statistics.median(total - inside for total, inside in jobs) if jobs else None
