"""The control of ``correct``: the plain reference put in the program's
place, with one guarantee of the configuration broken, judged by the same
comparison as a run.

The configurations state exact integer counts and no floating precision.
So the control breaks exactness.  It keeps each count in a 16-bit float
(``torch.float16``), as a narrower count column would, and reads it back.
Counts above 2,048 then round.  A sound comparison has to find that.
The benchmark's own runs never run this.  Run it on the card at a cell's own
size:

    python3 perfbench/control.py --workload nyt.job --seeds 11 12 13

It prints one JSON line a seed with the numbers compared and ``correct``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTROL_DTYPE = "float16"


def control_checks(cell: dict, config: dict, traffic: dict, seed: int, device):
    """The control's checks for one seed, as a run of ``cell`` would make them."""
    import torch
    from perfbench.harness import Bench
    from perfbench.drivers import job as job_driver
    from perfbench.drivers import stream as stream_driver
    dtype = getattr(torch, CONTROL_DTYPE)
    bench = Bench(cell=cell, config=config, traffic=traffic, seed=seed, seconds=0.0,
                  trace=False, device=device, t_start=time.perf_counter())
    if traffic["driver"] == "job":
        from perfbench import corpus
        tokens = corpus.make_corpus(config, seed, device)
        want = job_driver.expected(tokens, config)
        ctrl = job_driver.expected(tokens, config, count_dtype=dtype)
        job_driver.check(bench, [job_driver.rows(*ctrl)], want)
    elif traffic["driver"] == "stream":
        work = stream_driver.Workload(config, traffic, seed, device)
        n_deltas = len(work.deltas)
        ctrl = work.reference(count_dtype=dtype)
        answers = [(d, ctrl.lookups(d, d), ctrl.continuations(n_deltas + d, d, work.k))
                   for d in range(n_deltas)]
        indexes = [(n_deltas - 1, ctrl.index(n_deltas - 1))]
        del ctrl
        stream_driver.check(bench, work, answers, indexes, work.reference())
    else:
        raise ValueError(f"no control for driver {traffic['driver']!r}")
    return bench


def main(argv) -> int:
    sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from perfbench import harness
    ap = argparse.ArgumentParser(description="the control of correct, on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell, config, traffic = harness.load_cell(json.loads(harness.BENCHMARK.read_text()),
                                              args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        bench = control_checks(cell, config, traffic, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": CONTROL_DTYPE,
                          "correct": bench.checks.ok, "checks": bench.checks.items,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
