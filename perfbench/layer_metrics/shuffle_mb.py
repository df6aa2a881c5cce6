"""shuffle_mb: the job's shuffle volume in MB (10**6 bytes), the program's
``shuffle_bytes`` counter: the records left after the combiner at 4 bytes a
lane, as the paper counts MAP_OUTPUT_BYTES."""
LAYER = "shuffle (mapreduce/shuffle)"
UNIT = "MB"
MOVES = "job_terms_per_s"
SOURCE = "program_counter"


def value(record):
    counters = record.get("counters") or {}
    return counters["shuffle_bytes"] / 1e6 if "shuffle_bytes" in counters else None
