"""Helpers of the benchmark's tests: the cells of ``BENCHMARK.json`` run in
process on the CPU, with their configurations cut to a tiny size."""
from __future__ import annotations

import json
import time

import torch

from perfbench import harness

#: per driver: the configuration's corpus size and the traffic's cuts
TINY = {
    "job": ({"terms": 60_000}, {}),
    "stream": ({"terms": 65_536, "tau": 2}, {"delta_positions": 16_384, "lookups": 128, "prefixes": 64}),
}


def spec() -> dict:
    return json.loads(harness.BENCHMARK.read_text())


def cell_inputs(name: str, *, terms: int | None = None):
    """(cell, configuration, traffic) of a cell, cut to a tiny size."""
    cell, config, traffic = harness.load_cell(spec(), name)
    cut_cfg, cut_traffic = TINY[traffic["driver"]]
    config.update(cut_cfg)
    traffic.update(cut_traffic)
    if terms is not None:
        config["terms"] = terms
    if traffic["driver"] != "stream" and config["sigma"] > 20:
        config["tau"] = 20          # enough frequent long grams at a tiny size
    return cell, config, traffic


def run_cell(name: str, *, seed: int = 2**31 + 7, seconds: float = 0.3, trace: bool = False,
             terms: int | None = None):
    """(result object, bench) of one tiny run of cell ``name`` on the CPU."""
    cell, config, traffic = cell_inputs(name, terms=terms)
    bench = harness.Bench(cell=cell, config=config, traffic=traffic, seed=seed,
                          seconds=seconds, trace=trace, device=torch.device("cpu"),
                          t_start=time.perf_counter())
    return harness.execute(spec(), bench), bench
