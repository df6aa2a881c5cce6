"""lcp_boundary_roofline: the least time of one job's reducer boundaries
(``perfbench.kernel_bounds.lcp_boundary_s`` over the rows the combiner
leaves, the job's ``shuffle_records``) over the device time of the
``lcp_boundary_kernel`` launches of one job (torch.profiler, the traced jobs'
sum over their number), in percent."""
from perfbench.kernel_bounds import lcp_boundary_s

LAYER = "kernels (kernels/ops, csrc/*.cu)"
UNIT = "%"
MOVES = "job_terms_per_s"
SOURCE = "device_trace"


def value(record):
    traced = record.get("traced")
    rows = (record.get("counters") or {}).get("shuffle_records")
    if traced is None or not rows:
        return None
    seconds, launches = traced.kernel_s("lcp_boundary_kernel")
    if not launches or seconds <= 0:
        return None
    return 100 * lcp_boundary_s(int(rows), record["sigma"]) / (seconds / record["traced_jobs"])
