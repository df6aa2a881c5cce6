"""Span tracer: nested wall-clock spans -> Chrome/Perfetto ``trace_event`` JSON.

Port of ``repro.obs.trace``.  Instrumented code never checks whether
tracing is on:

    with trace.span("round.stages") as sp:
        if sp:                   # a real span: attach args / device sync
            sp.set(round=k)
            sp.sync(tensors)     # torch.cuda.synchronize() at span close
        ...

``span`` returns the shared :data:`NULL_SPAN` while tracing is disabled -- no
allocation, no clock read, no device sync.  Enabled, a span records a host
``perf_counter_ns`` interval; a span given CUDA tensors through ``sp.sync``
synchronizes the device at its close, so its duration covers the device work
it launched instead of the asynchronous launch alone.

Every finished event carries ``args.id``, a number unique within its tracer,
and ``args.parent``, the id of the span that was open on the same thread when
it opened (None at a root): a span's self time is its duration less the
children that name it.
"""
from __future__ import annotations

import itertools
import json
import threading
import time

import torch

__all__ = ["NULL_SPAN", "Span", "Tracer", "enable_tracing", "disable_tracing",
           "get_tracer", "span", "span_coverage"]


class _NullSpan:
    """Shared do-nothing span: the disabled path's zero-cost stand-in."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> None:
        pass

    def sync(self, _x) -> None:
        pass


NULL_SPAN = _NullSpan()


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(v) for v in x)
    return False


class Span:
    """One live span; closes (and optionally device-syncs) on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "t0", "t1", "tid", "_sync", "id", "parent")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0
        self.t1 = 0
        self.tid = threading.get_ident() & 0xFFFF
        self._sync = False
        self.id = 0
        self.parent = None

    def __bool__(self) -> bool:
        return True

    def set(self, **args) -> None:
        """Attach key/value args (rendered in the Perfetto detail pane)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def sync(self, x) -> None:
        """Synchronize the device at span close if ``x`` holds CUDA tensors."""
        self._sync = self._sync or _on_cuda(x)

    def __enter__(self) -> "Span":
        stack = self._tracer._open_spans()
        self.parent = stack[-1].id if stack else None
        self.id = next(self._tracer._ids)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._sync:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self._tracer._open_spans().remove(self)
        self._tracer._finish(self)
        return False


class Tracer:
    """Collects finished spans; exports Chrome ``trace_event`` JSON."""

    def __init__(self):
        self.events: list[dict] = []
        self._t_origin = time.perf_counter_ns()
        self._ids = itertools.count(1)      # next() is atomic under the GIL
        self._local = threading.local()

    def span(self, name: str, **args) -> Span:
        return Span(self, name, args or None)

    def _open_spans(self) -> list:
        """The calling thread's open spans, outermost first."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, sp: Span) -> None:
        ev = {
            "name": sp.name,
            "ph": "X",
            "cat": "repro_torch",
            "ts": (sp.t0 - self._t_origin) / 1e3,    # us, Chrome's unit
            "dur": (sp.t1 - sp.t0) / 1e3,
            "pid": 0,
            "tid": sp.tid,
        }
        args = {k: _jsonable(v) for k, v in sp.args.items()} if sp.args else {}
        args["id"] = sp.id
        args["parent"] = sp.parent
        ev["args"] = args
        self.events.append(ev)

    def export(self) -> dict:
        """The Perfetto-loadable trace object (sorted by start time)."""
        return {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f, indent=1)


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    try:
        return int(v)          # numpy / tensor scalars
    except (TypeError, ValueError):
        return str(v)


_TRACER: Tracer | None = None


def enable_tracing(tracer: Tracer | None = None) -> Tracer:
    """Install (and return) the active tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable_tracing() -> None:
    global _TRACER
    _TRACER = None


def get_tracer() -> Tracer | None:
    return _TRACER


def span(name: str):
    """A span under the active tracer, or :data:`NULL_SPAN` when disabled."""
    if _TRACER is None:
        return NULL_SPAN
    return _TRACER.span(name)


def span_coverage(trace_obj: dict, root_name: str,
                  child_prefixes: tuple[str, ...] | None = None) -> float:
    """Fraction of the root span's wall time covered by named child spans.

    The per-wave-tax attribution check: merge every non-root span's
    ``[ts, ts+dur)`` interval (optionally filtered to ``child_prefixes``),
    clip to the root span, and return covered/total.  A trace where this is
    low has anonymous wall time no span accounts for.
    """
    events = trace_obj["traceEvents"]
    roots = [e for e in events if e["name"] == root_name]
    if not roots:
        raise ValueError(f"no span named {root_name!r} in trace")
    root = max(roots, key=lambda e: e["dur"])
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    if r1 <= r0:
        return 0.0
    ivals = []
    for e in events:
        if e is root or e["name"] == root_name:
            continue
        if child_prefixes is not None and \
                not e["name"].startswith(child_prefixes):
            continue
        lo = max(e["ts"], r0)
        hi = min(e["ts"] + e["dur"], r1)
        if hi > lo:
            ivals.append((lo, hi))
    ivals.sort()
    covered = 0.0
    cur_lo, cur_hi = None, None
    for lo, hi in ivals:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered / (r1 - r0)
