"""Reporting: JSONL sink, summary table, env metadata, schema validators
(port of ``repro.obs.report``).

The job and serving drivers hand a :class:`~repro_torch.obs.metrics
.MetricsRegistry` snapshot (plus an optional trace) to this module, which

  * appends JSON-lines records (:func:`write_jsonl`) -- one self-contained
    snapshot per line, greppable and diffable like the ``BENCH_*.json`` files;
  * renders the human summary (:func:`summary_table`) the CLIs print;
  * stamps :func:`environment_metadata` (torch and CUDA versions, the device
    kind, name and count) so every recorded number says what hardware
    produced it;
  * validates exported artifacts against the schemas
    (:func:`validate_trace` / :func:`validate_metrics`) -- hand-rolled
    structural checks, zero dependencies, also a command line:

        python -m repro_torch.obs.report --validate-trace t.json \\
                                         --validate-metrics m.jsonl
"""
from __future__ import annotations

import json
import sys

__all__ = ["environment_metadata", "write_jsonl", "summary_table",
           "validate_trace", "validate_metrics", "setup"]


def setup(trace_path: str | None = None, metrics_path: str | None = None):
    """Wire the ``--trace`` / ``--metrics`` driver flags; returns ``finish``.

    Enables the tracer and/or installs a fresh registry (no-ops when both
    paths are ``None`` -- the flags-off invocation stays on the null
    singletons).  The returned ``finish(extra=None)`` exports the artifacts:
    trace JSON to ``trace_path``, one snapshot record (metrics + env + extra)
    appended to ``metrics_path`` JSONL, and prints the summary table.
    """
    from . import metrics as metrics_mod
    from . import trace as trace_mod

    tracer = trace_mod.enable_tracing() if trace_path else None
    reg = metrics_mod.MetricsRegistry() if metrics_path else None
    if reg is not None:
        metrics_mod.set_registry(reg)

    def finish(extra: dict | None = None):
        if tracer is not None:
            tracer.save(trace_path)
            print(f"trace: {trace_path} ({len(tracer.events)} spans)")
        if reg is not None:
            rec = {"env": environment_metadata(),
                   "metrics": reg.snapshot()}
            if extra:
                rec.update(extra)
            write_jsonl(metrics_path, [rec])
            table = summary_table(rec["metrics"])
            if table:
                print(table)
            print(f"metrics: {metrics_path}")
        return reg

    return finish


def environment_metadata() -> dict:
    """What produced this number: torch/CUDA/device facts for perf records."""
    import platform

    import torch

    meta = {"python": platform.python_version(),
            "platform": platform.platform(),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}
    if torch.cuda.is_available():
        meta.update(device_kind="cuda", device_name=torch.cuda.get_device_name(0),
                    device_count=torch.cuda.device_count())
    else:
        meta.update(device_kind="cpu", device_name=platform.processor() or "cpu",
                    device_count=0)
    return meta


def write_jsonl(path: str, records) -> int:
    """Append records (dicts) to a JSONL file; returns the number written."""
    n = 0
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _fmt_num(v) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:,.4g}"
    return f"{int(v):,}"


def summary_table(snapshot: dict) -> str:
    """Human-readable rendering of a registry snapshot (the CLI footer)."""
    lines = []
    counters = snapshot.get("counters", {})
    gauges = snapshot.get("gauges", {})
    if counters or gauges:
        lines.append("-- counters / gauges " + "-" * 38)
        for k, v in sorted({**counters, **gauges}.items()):
            lines.append(f"  {k:<40} {_fmt_num(v):>15}")
    hists = snapshot.get("histograms", {})
    if hists:
        lines.append("-- histograms (s) " + "-" * 41)
        lines.append(f"  {'name':<28} {'n':>7} {'p50':>9} {'p95':>9} "
                     f"{'p99':>9} {'max':>9}")
        for k, h in sorted(hists.items()):
            lines.append(
                f"  {k:<28} {h['count']:>7} {h['p50']:>9.2e} "
                f"{h['p95']:>9.2e} {h['p99']:>9.2e} {h['max']:>9.2e}")
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# schema validation (structural, dependency-free)
# --------------------------------------------------------------------------- #

def validate_trace(obj: dict) -> list[str]:
    """Errors ([] = valid) for a Chrome ``trace_event`` JSON object."""
    errs: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["trace must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    if not events:
        errs.append("trace has no events")
    for i, e in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(e.get("name"), str) or not e.get("name"):
            errs.append(f"{where}: missing/empty 'name'")
        if e.get("ph") != "X":
            errs.append(f"{where}: 'ph' must be 'X' (complete event)")
        for k in ("ts", "dur"):
            v = e.get(k)
            if not isinstance(v, (int, float)) or v < 0:
                errs.append(f"{where}: '{k}' must be a number >= 0")
        for k in ("pid", "tid"):
            if not isinstance(e.get(k), int):
                errs.append(f"{where}: '{k}' must be an int")
        if "args" in e and not isinstance(e["args"], dict):
            errs.append(f"{where}: 'args' must be an object")
    return errs


def validate_metrics(snapshot: dict) -> list[str]:
    """Errors ([] = valid) for one ``MetricsRegistry.snapshot()`` record."""
    errs: list[str] = []
    if not isinstance(snapshot, dict):
        return ["metrics snapshot must be an object"]
    for sect in ("counters", "gauges", "histograms"):
        if sect not in snapshot:
            errs.append(f"missing section '{sect}'")
    for sect in ("counters", "gauges"):
        for k, v in snapshot.get(sect, {}).items():
            if not isinstance(v, (int, float)):
                errs.append(f"{sect}[{k}]: value must be a number")
    for k, h in snapshot.get("histograms", {}).items():
        where = f"histograms[{k}]"
        if not isinstance(h, dict):
            errs.append(f"{where}: must be an object")
            continue
        b = h.get("boundaries")
        c = h.get("counts")
        if not isinstance(b, list) or sorted(b) != b or len(set(b)) != len(b):
            errs.append(f"{where}: 'boundaries' must be strictly increasing")
        if not isinstance(c, list) or not isinstance(b, list) or \
                len(c) != len(b) + 1:
            errs.append(f"{where}: len(counts) must be len(boundaries)+1")
        elif any((not isinstance(x, int)) or x < 0 for x in c):
            errs.append(f"{where}: counts must be non-negative ints")
        elif h.get("count") != sum(c):
            errs.append(f"{where}: 'count' != sum(counts)")
        for fld in ("count", "sum", "min", "max", "p50", "p95", "p99"):
            if not isinstance(h.get(fld), (int, float)):
                errs.append(f"{where}: missing numeric '{fld}'")
    return errs


def main(argv=None) -> int:
    """CLI validator: exit 0 iff every artifact is valid."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--validate-trace", default=None,
                    help="Chrome trace_event JSON file to validate")
    ap.add_argument("--validate-metrics", default=None,
                    help="metrics JSONL file to validate (every line)")
    args = ap.parse_args(argv)
    rc = 0
    if args.validate_trace:
        with open(args.validate_trace) as f:
            obj = json.load(f)
        errs = validate_trace(obj)
        n_events = 0 if errs else len(obj["traceEvents"])
        if errs:
            rc = 1
            print(f"TRACE INVALID ({args.validate_trace}):", file=sys.stderr)
            for e in errs[:20]:
                print(f"  {e}", file=sys.stderr)
        else:
            print(f"trace ok: {args.validate_trace} ({n_events} events)")
    if args.validate_metrics:
        records = read_jsonl(args.validate_metrics)
        errs = (["metrics file has no records"] if not records else
                [f"line {i}: {e}" for i, rec in enumerate(records)
                 for e in validate_metrics(rec.get("metrics", rec))])
        if errs:
            rc = 1
            print(f"METRICS INVALID ({args.validate_metrics}):",
                  file=sys.stderr)
            for e in errs[:20]:
                print(f"  {e}", file=sys.stderr)
        else:
            print(f"metrics ok: {args.validate_metrics} "
                  f"({len(records)} records)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
