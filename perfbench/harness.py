"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload nyt.job --seed 7 --seconds 20 --trace 0

The harness reads the cell from ``BENCHMARK.json`` and finds everything
else by name:

* the configuration: the ``file`` named in its ``configs`` entry;
* the traffic mix: ``perfbench/traffic/<traffic>.json``.  Its ``driver``
  key names the general driver, ``perfbench/drivers/<driver>.py``, and the
  rest are that driver's parameters;
* each end-to-end metric: ``perfbench/metrics/<name>.py``;
* each per-layer metric: ``perfbench/layer_metrics/<name>.py``.

A metric module has ``value(record)``.  It returns the metric from the
run's record, or None when there is nothing to read.  The driver makes its
inputs from ``--seed``, sets up, warms every shape, measures for
``--seconds``, then checks the outputs against the plain reference in
``perfbench/reference``.  The last line of standard output is the result as
one JSON object.  The last lines of standard error give each number
compared beside its limit.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT / "BENCHMARK.json"
PERFBENCH = ROOT / "perfbench"
#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["Bench", "main", "prepare", "execute", "load_cell", "load_metric",
           "forbidden_modules", "cell_metrics"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def load_cell(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of cell ``name`` of ``spec``, each
    found by the name that ``BENCHMARK.json`` gives it."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((PERFBENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def load_metric(kind: str, name: str):
    """The module of metric ``name``: ``perfbench/<kind>/<name>.py``."""
    path = PERFBENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no metric module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries a cell reports."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per


class Bench:
    """One run: what the harness hands a driver, and what the driver fills.

    The driver fills ``record`` (metric modules read it) and ``checks``,
    ``attempted`` and ``failed``.  It calls :meth:`window_opens` when
    set-up ends and :meth:`window_closes` when the window ends.
    """

    def __init__(self, *, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device, t_start: float):
        from perfbench.compare import Checks
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.record: dict = {}
        self.checks = Checks()
        self.attempted = 0
        self.failed = 0
        self._setup_peak = 0
        self.marks: list[tuple[str, float]] = [("start", t_start)]

    def mark(self, label: str) -> None:
        """Note the host clock at a step of set-up (printed on standard error)."""
        self.marks.append((label, time.perf_counter()))

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def window_opens(self) -> float:
        """End set-up: record ``setup_s`` and the set-up's peak, reset the
        peak, and return the window's start on the host clock."""
        import torch
        if self._cuda():
            torch.cuda.synchronize(self.device)
            self._setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.marks.append(("window opens", now))
        self.record["setup_s"] = now - self.t_start
        return now

    def window_closes(self) -> None:
        """Record the window's own peak (``window_peak_bytes``) and the
        run's (``memory_peak_bytes``)."""
        import torch
        peak = 0
        if self._cuda():
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
        self.marks.append(("window", time.perf_counter()))
        self.record["window_peak_bytes"] = peak
        self.record["memory_peak_bytes"] = max(peak, self._setup_peak)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fail(msg: str, code: int = 2) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def prepare(argv, t_start: float, device=None):
    """Parse the arguments and build the run's :class:`Bench`.  Without
    ``device`` the run takes the card and refuses to run without one (and
    without as many cards as the cell asks for)."""
    args = _parse(argv)
    spec = json.loads(BENCHMARK.read_text())
    try:
        cell, config, traffic = load_cell(spec, args.workload)
    except KeyError as e:
        raise SystemExit(_fail(e.args[0]))
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(_fail("no CUDA device: the benchmark runs only on the card", 3))
        if torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(_fail(f"{cell['name']} needs {cell['chips']} cards, "
                                   f"found {torch.cuda.device_count()}", 3))
        device = torch.device("cuda", 0)
        torch.cuda.init()
    bench = Bench(cell=cell, config=config, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=torch.device(device),
                  t_start=t_start)
    bench.mark("imports and card")
    return spec, bench


def execute(spec: dict, bench: Bench) -> dict:
    """Run the cell's driver and build the result object."""
    driver = importlib.import_module(f"perfbench.drivers.{bench.traffic['driver']}")
    driver.run(bench)
    bench.mark("reference and checks")
    e2e, per = cell_metrics(spec, bench.cell["name"])
    chosen = per if bench.trace else e2e
    kind = "layer_metrics" if bench.trace else "metrics"
    metrics = {}
    for m in chosen:
        v = load_metric(kind, m["name"]).value(bench.record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    missing = [m["name"] for m in e2e if m["name"] not in metrics] if not bench.trace else []
    if missing:
        raise RuntimeError(f"end-to-end metrics without a value: {missing}")
    import torch
    dev = bench.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": int(bench.cell["chips"]),
              "memory_peak_bytes": int(bench.record.get("memory_peak_bytes", 0))}
    out = {"correct": bool(bench.checks.ok), "attempted": int(bench.attempted),
           "failed": int(bench.failed), "metrics": metrics, "device": device}
    traced = bench.record.get("traced")
    if bench.trace and traced is not None:
        device["busy_s"] = traced.busy_s
        device["window_s"] = traced.window_s
        out["breakdown"] = {"device_ops": traced.device_ops(), "idle_gaps": traced.idle_gaps()}
    out["checks"] = bench.checks.items
    return out


def main(argv, t_start: float) -> int:
    try:
        spec, bench = prepare(argv, t_start)
    except SystemExit as e:
        return int(e.code or 2)
    result = execute(spec, bench)
    found = forbidden_modules()
    if found:
        return _fail(f"modules of JAX or the JAX package were loaded: {found}", 4)
    from perfbench import devtrace
    import torch
    steps = ", ".join(f"{label} {t - prev:.3f} s" for (_, prev), (label, t)
                      in zip(bench.marks, bench.marks[1:]))
    print(f"steps: {steps}", file=sys.stderr)
    print(f"card: {torch.cuda.get_device_name(bench.device)}, power limit "
          f"{devtrace.power_limit_w() or 'not read'}", file=sys.stderr)
    for line in bench.checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
