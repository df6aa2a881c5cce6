"""Reading the device trace: torch.profiler's CUDA activity over a traced
window, the H100's published peaks, and the least time a kernel's work
can take.

Peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data
sheet): 3.35 TB/s of HBM3, and 67 TFLOP/s of float32 outside the tensor
cores, which is the rate this benchmark uses for the kernels' scalar
integer work.  A card set below 700 W runs slower: the result line names
the card, and ``power_limit_w`` reads its limit.
"""
from __future__ import annotations

import re
import subprocess
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "SCALAR_OPS_PER_S", "bound_s", "power_limit_w",
           "Traced", "idle_share_pct", "traced"]

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
_ANCHOR = "perfbench.anchor"


def bound_s(bytes_moved: float, ops_done: float) -> float:
    """The least seconds the chip could take: the larger of the bytes over
    the HBM bandwidth and the operations over the scalar rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops_done / SCALAR_OPS_PER_S)


def power_limit_w() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Traced:
    """What one traced window's device activity says.

    ``intervals``: (start, end) microseconds of every kernel, copy and set
    on the device, on the profiler's clock, cut to the window.
    ``window_us``: (start, end) of the window on that clock.  ``spans``:
    the program's spans as (name, start, end) on the same clock.
    """

    def __init__(self, events: list, window_us: tuple[float, float], spans: list):
        self.events = events          # (name, start_us, end_us) device events
        self.window_us = window_us
        self.spans = spans

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def _merged(self) -> list[tuple[float, float]]:
        lo_w, hi_w = self.window_us
        merged: list[list[float]] = []
        for _, s, e in sorted(self.events, key=lambda ev: ev[1]):
            s, e = max(s, lo_w), min(e, hi_w)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        """Seconds in which the device ran at least one kernel or copy: the
        union of the events' intervals (a sum would count overlaps twice)."""
        return sum(e - s for s, e in self._merged()) / 1e6

    def kernel_s(self, kernel: str) -> tuple[float, int]:
        """(device seconds, launches) of the ``__global__`` function ``kernel``."""
        name = re.compile(rf"\b{re.escape(kernel)}\b")
        hits = [e - s for n, s, e in self.events if name.search(n)]
        return sum(hits) / 1e6, len(hits)

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by: dict[str, float] = {}
        for n, s, e in self.events:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:120], v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[label, seconds] of the device's idle time by what the host was
        doing then: the innermost program span around each gap's middle
        (``plan.run`` alone is the host finish outside its rounds), or
        ``outside spans``."""
        lo_w, hi_w = self.window_us
        edges = [lo_w] + [x for se in self._merged() for x in se] + [hi_w]
        by: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inner = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
            label = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "outside spans"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_share_pct(record) -> float | None:
    """The traced window's share in which the card ran no kernel and no copy
    on any stream, in percent; None without a traced window."""
    traced = record.get("traced")
    if traced is None or traced.window_s <= 0 or traced.busy_s <= 0:
        return None
    return 100 * (1 - traced.busy_s / traced.window_s)


def traced(fn, tracer=None) -> Traced:
    """Run ``fn`` once under torch.profiler (CPU and CUDA activity) and read
    its device events.  ``tracer``: the program's span tracer, whose spans
    in the window are placed on the profiler's clock through an anchor
    range that the profiler and the host clock both see."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    first_span = len(tracer.events) if tracer is not None else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_ANCHOR):
            anchor_ns = time.perf_counter_ns()
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    anchor = [ev for ev in prof.events() if ev.name == _ANCHOR]
    base_us = anchor[0].time_range.start if anchor else 0.0

    def on_prof(ns: float) -> float:
        return base_us + (ns - anchor_ns) / 1e3

    events = [(ev.name, ev.time_range.start, ev.time_range.end) for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    spans = []
    if tracer is not None:
        origin = getattr(tracer, "_t_origin", None)
        if origin is not None:
            for ev in tracer.events[first_span:]:
                s = origin + ev["ts"] * 1e3
                spans.append((ev["name"], on_prof(s), on_prof(s + ev["dur"] * 1e3)))
    return Traced(events, (on_prof(t0), on_prof(t1)), spans)
