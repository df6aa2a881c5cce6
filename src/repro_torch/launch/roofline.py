"""Roofline terms of a dry-run trace (port of ``repro.launch.roofline``).

  compute_s    = FLOPs a device / peak of the compute dtype
  memory_s     = HBM bytes a device / HBM bandwidth
  collective_s = collective bytes a device / link bandwidth

with the H100's constants (``launch.mesh``): the peak is the dense bf16
tensor-core rate for a cell whose matmuls run in bf16 (the LMs), and the
float32 rate without tensor cores for one that runs in float32 with TF32
off (the recsys archs and GIN).  ``repro`` reads XLA's
``cost_analysis`` and parses the compiled HLO's collectives; the port's
counts come from the dry run's trace (``launch.dryrun``): each op a device
runs on its local shards, its FLOPs by ``torch.utils.flop_counter``'s
registry applied to the local shapes, its HBM bytes its inputs and outputs
read and written once, and each collective's result bytes by kind.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class Roofline:
    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int
    model_flops: float = 0.0
    collective_detail: dict = field(default_factory=dict)
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.bytes_collective / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound is the sum; perfectly-overlapped lower bound
        is the max.  The max is reported (roofline convention)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / global FLOPs: catches remat / redundancy waste."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / max(self.flops * self.chips, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-achievable fraction of peak at the modeled step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * self.peak_flops)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops, "bytes_per_chip": self.bytes_hbm,
            "collective_bytes_per_chip": self.bytes_collective,
            "chips": self.chips, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "collective_detail": self.collective_detail,
        }


def peak_flops(dtype: torch.dtype) -> float:
    """An H100's peak FLOP/s for matmuls in ``dtype``."""
    return PEAK_FLOPS_F32 if dtype == torch.float32 else PEAK_FLOPS_BF16


def analyze(counts: dict, chips: int, model_flops: float = 0.0,
            dtype: torch.dtype = torch.bfloat16) -> Roofline:
    """counts: a trace's ``{"flops", "bytes", "collectives": {kind: bytes,
    "count": n}}`` for one device; ``dtype`` the one its matmuls run in."""
    coll = {k: counts["collectives"].get(k, 0) for k in COLLECTIVES}
    coll["count"] = counts["collectives"].get("count", 0)
    return Roofline(flops=float(counts["flops"]), bytes_hbm=float(counts["bytes"]),
                    bytes_collective=float(sum(coll[k] for k in COLLECTIVES)),
                    chips=chips, model_flops=model_flops, collective_detail=coll,
                    peak_flops=peak_flops(dtype))
