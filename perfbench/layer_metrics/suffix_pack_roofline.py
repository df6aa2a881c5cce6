"""suffix_pack_roofline: the least time of one job's map emit
(``perfbench.kernel_bounds.suffix_pack_s`` at the job's positions) over the
device time of the ``suffix_pack_kernel`` launches of one job (torch.profiler,
the traced jobs' sum over their number), in percent."""
from perfbench.kernel_bounds import suffix_pack_s

LAYER = "kernels (kernels/ops, csrc/*.cu)"
UNIT = "%"
MOVES = "job_terms_per_s"
SOURCE = "device_trace"


def value(record):
    traced = record.get("traced")
    if traced is None:
        return None
    seconds, launches = traced.kernel_s("suffix_pack_kernel")
    if not launches or seconds <= 0:
        return None
    per_job = seconds / record["traced_jobs"]
    return 100 * suffix_pack_s(record["positions"], record["sigma"],
                               record["vocab_size"]) / per_job
