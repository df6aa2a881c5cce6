#!/usr/bin/env python3
"""Time the ``bsearch`` kernel at D = 1, 2, 3 and 4 levels of the halving tree
per round trip, on every search the main path and the streaming path make.

    python3 scripts/bsearch_levels.py      # from the repository root, one H100

It runs ``chip_smoke.py``'s phase 3 (main path) and phase 5 (streaming) with
``ops.bsearch`` recording each launch, builds ``csrc/bsearch.cu`` once for
each D (``-DBSEARCH_LEVELS=D``, all four compiles at once), replays every
recorded launch under each build, checks each answer against the recorded
one, and prints the kernel's device time (torch.profiler) summed by path and
by search shape: the launch-weighted totals from which the D the kernel is
built with was chosen.  Its output ends with one JSON line.
"""
from __future__ import annotations

import collections
import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild, ops  # noqa: E402

LEVELS = (1, 2, 3, 4)
REPS = 3


def record_launches(calls: list, path: list):
    """Make ``ops.bsearch`` append (path, args, kwargs, answer) of each call
    that launches the kernel; ``path[0]`` names the phase."""
    original = ops.bsearch

    def recording(lanes, queries, lo, hi, *, upper=False, steps=None):
        before = ops.launches["bsearch"]
        pos = original(lanes, queries, lo, hi, upper=upper, steps=steps)
        if ops.launches["bsearch"] > before:
            calls.append((path[0], (lanes, queries, lo, hi),
                          dict(upper=upper, steps=steps), pos))
        return pos

    ops.bsearch = recording
    return original


def device_ms(search, calls) -> list[float]:
    """Mean device ms of each call's kernel, over REPS launches each."""
    from torch.profiler import ProfilerActivity, profile
    fns = [lambda c=c: search(*c[1], **c[2]) for c in calls]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):          # the profiler can miss launches: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(REPS):
                    fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "bsearch_kernel" in e.name), key=lambda e: e.time_range.start)
        if len(ev) == REPS * len(fns):
            return [sum(e.time_range.elapsed_us() for e in ev[i * REPS:(i + 1) * REPS])
                    / REPS / 1e3 for i in range(len(fns))]
    raise RuntimeError(f"the profiler saw {len(ev)} of {REPS * len(fns)} launches")


def main() -> int:
    if not torch.cuda.is_available():
        print("bsearch_levels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}")
    out_dir = kbuild.BUILD_ROOT.parent / "bsearch_levels"
    libs = {d: out_dir / f"libbsearch_d{d}.so" for d in LEVELS}
    nvcc = {d: cs.start_nvcc(kbuild.CSRC / "bsearch.cu", libs[d],
                             defines=(f"BSEARCH_LEVELS={d}",)) for d in LEVELS}
    kbuild.entries()
    calls, path = [], ["main"]
    search = record_launches(calls, path)
    main_run = cs.phase_main_path(dev)
    path[0] = "stream"
    cs.phase_streaming(dev, main_run)
    ops.bsearch = search
    print(f"recorded {len(calls)} launches: "
          f"{dict(collections.Counter(c[0] for c in calls))}")

    built = kbuild.entries()["bsearch"]
    times = {}
    for d in LEVELS:
        fn = getattr(cs.finish_nvcc(nvcc[d], libs[d]), "bsearch_launch")
        fn.argtypes, fn.restype = kbuild.SIGNATURES["bsearch"], ctypes.c_int
        kbuild.entries()["bsearch"] = fn
        for c in calls:
            cs.check(torch.equal(search(*c[1], **c[2]), c[3]),
                     f"D={d} answers equal the built kernel's")
        times[d] = device_ms(search, calls)
    kbuild.entries()["bsearch"] = built

    shapes = collections.defaultdict(list)
    for i, (p, (lanes, queries, _, _), kw, _) in enumerate(calls):
        shapes[(p, tuple(lanes.shape), queries.shape[0], kw["upper"])].append(i)
    for (p, lanes, n_q, upper), ids in sorted(shapes.items()):
        per_d = ", ".join(f"D={d} {sum(times[d][i] for i in ids) / len(ids):.4f}"
                          for d in LEVELS)
        print(f"{p}: index {list(lanes)}, {n_q} queries, "
              f"{'upper' if upper else 'lower'}: {len(ids)} launches, mean ms {per_d}")
    totals = {d: {p: sum(t for t, c in zip(times[d], calls) if c[0] == p)
                  for p in ("main", "stream")} for d in LEVELS}
    for d in LEVELS:
        print(f"D={d}: device ms summed over the launches: main {totals[d]['main']:.4f}, "
              f"stream {totals[d]['stream']:.4f}, both "
              f"{totals[d]['main'] + totals[d]['stream']:.4f}")
    print(json.dumps({"launches": dict(collections.Counter(c[0] for c in calls)),
                      "total_ms": totals}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
