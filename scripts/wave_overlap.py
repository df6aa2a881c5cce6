#!/usr/bin/env python3
"""Time the wave engine's fold thread against the serial fold, and check
that torch.profiler sees every ``merge_path`` launch before and after it.

    python3 scripts/wave_overlap.py            # from the repository root, one H100
    python3 scripts/wave_overlap.py --causes   # the profiler check alone

SUFFIX-sigma (sigma 5, tau 10) on ``chip_smoke.py`` phase 3's corpus (2**25
NYT-profile terms) in waves of 2**23, for each (accumulator, merge route) in
CONFIGS, with ``overlap`` False and True in the order off, on, on, off: the
wall seconds of every run.  ``"kway"`` folds on the host, so there the fold
thread has host work to overlap with the next waves' device work.

The profiler check times ``merge_path`` as ``chip_smoke.py``'s
``kernel_ms`` does (one warm call, then PROBE_REPS calls in one profiler
window) at runs of 2**20, 2**24 and 2**27 - 2**23 rows, and prints how many
launches the profiler saw, with the window as is and with PAD_S seconds of
idle time at each end; once before any wave run, once after the first run
without the fold thread, once after every run, and once after
N_WINDOWS more short profiler windows.

``--causes`` runs the profiler check alone, after each suspect in turn: a
``non_blocking`` copy from pinned memory; CUDA work on a side stream of
the main thread (``wait_event``, ``record_stream``); CUDA work on a thread
of its own, on the default stream and on a side stream; IDLE_S seconds of
idle process time, twice; N_RUNS wave runs without the fold thread; and
N_RUNS with it.  The output ends with one JSON line.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import NGramConfig  # noqa: E402
from repro_torch.data import corpus  # noqa: E402
from repro_torch.kernels import build as kbuild, ops  # noqa: E402
from repro_torch.pipeline import WaveExecutor  # noqa: E402

WAVE = 1 << 23
CONFIGS = (("defer", "merge"), ("defer", "kway"), ("tiered", "kway"))
ORDER = (False, True, True, False)
PROBE_SIZES = (1 << 20, 1 << 24, (1 << 27) - (1 << 23))
PROBE_REPS = 10
PAD_S = 0.05
N_WINDOWS = 200
IDLE_S = 120
N_RUNS = 5


def sorted_run(n: int, gen: torch.Generator, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """A sorted run of n unique 4-lane keys (uint32 values in int64): lane 0
    strictly increasing, the rest random; values 0..n-1."""
    keys = torch.randint(0, 1 << 32, (n, 4), generator=gen, device=dev)
    keys[:, 0] = torch.randint(1, 17, (n,), generator=gen, device=dev).cumsum(0)
    return keys, torch.arange(n, device=dev)


def seen(fn, pad_s: float) -> tuple[int, int]:
    """(merge_path launches, device events) torch.profiler reports for
    PROBE_REPS calls of ``fn`` in one window, after one warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(PROBE_REPS):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return sum("merge_path_kernel" in n for n in names), len(names)


def probe(label: str, t_start: float, dev) -> dict:
    """The profiler check at every PROBE_SIZES run, unpadded and padded."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for n in PROBE_SIZES:
        (ak, av), (bk, bv) = sorted_run(n, gen, dev), sorted_run(n, gen, dev)
        bv += n
        fn = lambda: ops.merge_path(ak, bk, av, bv)  # noqa: E731
        got = {f"pad {pad}": seen(fn, pad) for pad in (0.0, PAD_S)}
        got["ms"] = cs.cuda_ms(fn, 3)
        out[n] = got
        print(f"probe: {label} (at {time.perf_counter() - t_start:.1f} s): runs of {n} rows, "
              f"{got['ms']:.4f} ms a call: merge_path launches seen of {PROBE_REPS} "
              + ", ".join(f"{k} s: {v[0]} ({v[1]} device events)"
                          for k, v in got.items() if k != "ms"))
        del ak, av, bk, bv, fn
        torch.cuda.empty_cache()
    return out


def causes(toks, cfg, t_start: float, dev) -> dict:
    """The profiler check after each suspect in turn (``--causes``)."""
    import threading

    def work():
        x = torch.randn(1 << 24, device=dev)
        (x * 2).sum().item()

    def on_side_stream():
        with torch.cuda.stream(torch.cuda.Stream()):
            work()

    def in_thread(fn):
        th = threading.Thread(target=fn)
        th.start()
        th.join()

    def pinned_copy():
        host = torch.zeros(1 << 24, dtype=torch.int32, pin_memory=True)
        host.to(dev, non_blocking=True)

    def side_stream():
        side, done = torch.cuda.Stream(), torch.cuda.Event()
        y = torch.ones(1 << 24, device=dev)
        done.record()
        with torch.cuda.stream(side):
            side.wait_event(done)
            y.record_stream(side)
            work()
        torch.cuda.current_stream().wait_stream(side)

    def waves(overlap: bool):
        for _ in range(N_RUNS):
            WaveExecutor(cfg, wave_tokens=WAVE, overlap=overlap, device=dev).run(toks)

    suspects = (
        ("a non_blocking copy from pinned memory", pinned_copy),
        ("a side stream of the main thread", side_stream),
        ("a thread on the default stream", lambda: in_thread(work)),
        ("a thread on a side stream", lambda: in_thread(on_side_stream)),
        (f"{IDLE_S} s idle", lambda: time.sleep(IDLE_S)),
        (f"{IDLE_S} s more idle", lambda: time.sleep(IDLE_S)),
        (f"{N_RUNS} wave runs without the fold thread", lambda: waves(False)),
        (f"{N_RUNS} wave runs with it", lambda: waves(True)),
    )
    out = {"fresh": probe("fresh process", t_start, dev)}
    for label, fn in suspects:
        fn()
        torch.cuda.synchronize()
        out[f"after {label}"] = probe(f"after {label}", t_start, dev)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("wave_overlap: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kbuild.entries()
    toks = corpus.zipf_corpus(cs.MAIN_TERMS, corpus.NYT, seed=0, duplicate_frac=0.02)
    cfg = NGramConfig(sigma=cs.SIGMA, tau=cs.TAU, vocab_size=corpus.NYT.vocab_size)
    if "--causes" in sys.argv[1:]:
        probes = causes(toks, cfg, t_start, dev)
        print(cs.card_line())
        print(json.dumps({"probes": {k: {str(n): v for n, v in p.items()}
                                     for k, p in probes.items()}}))
        return 0
    probes = {"fresh": probe("fresh process", t_start, dev)}
    want = WaveExecutor(cfg, device=dev).run(toks)
    times: dict[str, dict[str, list[float]]] = {}
    for acc, route in CONFIGS:
        key = f"{acc}/{route}"
        times[key] = {"on": [], "off": []}
        for overlap in ORDER:
            ex = WaveExecutor(cfg, wave_tokens=WAVE, accumulator=acc, merge_route=route,
                              overlap=overlap, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ex.run(toks)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            cs.check(cs.same_rows(out, want), f"{key}, overlap={overlap}: output == one wave's")
            times[key]["on" if overlap else "off"].append(secs)
            print(f"waves: {key}, waves of {WAVE}, overlap={overlap}: {secs:.3f} s, "
                  f"fold_rows {out.counters['fold_rows']:,}")
            if "after the first serial run" not in probes:
                probes["after the first serial run"] = probe(
                    "after the first run without the fold thread", t_start, dev)
        on, off = times[key]["on"], times[key]["off"]
        print(f"waves: {key}: fold thread {np.median(on):.3f} s (runs {on}), serial "
              f"{np.median(off):.3f} s (runs {off})")
    probes["after the wave runs"] = probe("after every wave run", t_start, dev)

    x = torch.zeros(1 << 20, device=dev)
    for _ in range(N_WINDOWS):
        cs.device_launches(lambda: x.add_(1), 2)
    probes[f"after {N_WINDOWS} windows"] = probe(
        f"after {N_WINDOWS} more profiler windows", t_start, dev)

    print(cs.card_line())
    print(json.dumps({"times_s": times, "probes": {
        k: {str(n): v for n, v in p.items()} for k, p in probes.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
