"""device_idle_share: the share of the traced jobs' wall time in which the
card ran no kernel and no copy on any stream (1 - the union of the device
events' intervals over the traced window; torch.profiler), in percent."""
from perfbench.devtrace import idle_share_pct as value

LAYER = "device (H100)"
UNIT = "%"
MOVES = "job_terms_per_s"
SOURCE = "device_trace"

__all__ = ["value"]
