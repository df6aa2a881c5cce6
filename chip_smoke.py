#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every result.

    python3 chip_smoke.py            # from the repository root, on a CUDA host

Phases (any failure raises, and the script exits non-zero without its last
line):

  1. build    -- compile the four CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. oracle   -- the paper's running example and ~50k NYT-profile tokens
                 through ``run_job`` -> ``build_index`` -> ``lookup`` /
                 ``continuations`` on the card, against the pure-Python oracle;
  3. main path -- 2**25 NYT-profile terms, sigma=5, tau=10: the job, the index,
                 2**16 point lookups (half hits, half misses or malformed) and
                 2**14 top-8 continuation queries, each checked exactly; every
                 kernel's launch counter must move during this phase;
  4. kernels  -- each CUDA kernel against its plain PyTorch version on the card,
                 at the shapes the main path gave it and on edge cases (exact
                 equality), with its time, the plain version's time and the
                 least time the card could take (``bound_ms``).

The last lines are one JSON object describing each kernel, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.  The
script needs one card; without CUDA it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import NGramConfig, oracle, run_job  # noqa: E402
from repro_torch.core import suffix_sigma  # noqa: E402
from repro_torch.data import corpus  # noqa: E402
from repro_torch.index import build_index, continuations, lookup  # noqa: E402
from repro_torch.index import query as index_query  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.mapreduce import pack  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.pipeline import stages  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth, and
# the 32-bit non-tensor rate, the table's figure for the scalar integer work
# these kernels do
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

MAIN_TERMS = 1 << 25
SIGMA, TAU = 5, 10
N_LOOKUPS, N_PREFIXES, TOP_K = 1 << 16, 1 << 14, 8

KERNELS = {
    "suffix_pack": "src/repro/kernels/suffix_pack.py:60",
    "hash_partition": "src/repro/kernels/hash_partition.py:49",
    "lcp_boundary": "src/repro/kernels/lcp_boundary.py:51",
    "bsearch": "src/repro/kernels/bsearch.py:84",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def wall_times(fn, sync, reps: int) -> list[float]:
    """Host seconds of each of ``reps`` calls of ``fn``, each ended by ``sync``."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest absolute difference over all outputs; shapes must agree."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    check(len(got) == len(want), "output count")
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def grams_matrix(gram_tuples, sigma):
    g = np.zeros((len(gram_tuples), sigma), np.int32)
    ln = np.zeros(len(gram_tuples), np.int32)
    for i, t in enumerate(gram_tuples):
        g[i, : len(t)] = t
        ln[i] = len(t)
    return g, ln


def row_keys(lengths: np.ndarray, grams: np.ndarray) -> np.ndarray:
    """[R] byte keys of (length | grams) rows whose order is the numeric order
    (big-endian, values >= 0), for exact host-side matching."""
    rows = np.concatenate([lengths[:, None], grams], axis=1).astype(">i4")
    return np.ascontiguousarray(rows).view(np.dtype((np.void, 4 * rows.shape[1])))[:, 0]


# --------------------------------------------------------------------- phase 2
def phase_oracle(dev) -> None:
    """Small corpora end to end on ``dev`` against the pure-Python oracle."""
    paper = np.asarray([1, 3, 2, 3, 3, 0, 2, 1, 3, 2, 3, 0, 3, 2, 1, 3, 2], np.int32)
    small = corpus.zipf_corpus(50_000, corpus.NYT, seed=1, duplicate_frac=0.05)
    for toks, sigma, tau, vocab in ((paper, 3, 3, 3),
                                    (small, 4, 4, corpus.NYT.vocab_size)):
        stats = run_job(toks, NGramConfig(sigma=sigma, tau=tau, vocab_size=vocab),
                        device=dev)
        exp = oracle.ngram_counts(toks, sigma, tau)
        check(stats.to_dict() == exp, f"job == oracle ({len(exp)} grams)")
        idx = build_index(stats, vocab_size=vocab, device=dev)
        grams = sorted(exp)
        g, ln = grams_matrix(grams, sigma)
        got = lookup(idx, g, ln).cpu().numpy()
        check(np.array_equal(got, [exp[t] for t in grams]), "lookup == oracle")
        rng = np.random.default_rng(2)
        pool = [t[:-1] for t in grams if len(t) >= 2]
        prefixes = [()] + [pool[i] for i in rng.choice(len(pool), 40)]
        pg, pl = grams_matrix(prefixes, sigma)
        nd, total, terms, counts = (x.cpu().numpy() for x in
                                    continuations(idx, pg, pl, k=4))
        for i, p in enumerate(prefixes):
            ext = {t[-1]: c for t, c in exp.items()
                   if len(t) == len(p) + 1 and t[:len(p)] == p}
            check(nd[i] == len(ext) and total[i] == sum(ext.values()),
                  f"continuation mass of {p}")
            check([int(c) for c in counts[i] if c] ==
                  sorted(ext.values(), reverse=True)[:4], f"top-4 of {p}")
            check(all(ext[int(t)] == int(c) for t, c in zip(terms[i], counts[i]) if c),
                  f"top-4 pairs of {p}")
        print(f"oracle: {len(toks)} tokens sigma={sigma} tau={tau}: "
              f"{len(exp)} grams, lookups and continuations equal the oracle")


# --------------------------------------------------------------------- phase 3
def lookup_batch(stats, rng, n: int, vocab: int):
    """Half hits sampled from the job output, half misses or malformed."""
    sigma = stats.grams.shape[1]
    n_hit = n // 2
    rows = rng.integers(0, len(stats), n_hit)
    g_hit, l_hit = stats.grams[rows], stats.lengths[rows]
    l_miss = rng.integers(1, sigma + 1, n - n_hit).astype(np.int32)
    g_miss = rng.integers(1, vocab + 1, (n - n_hit, sigma)).astype(np.int32)
    g_miss *= np.arange(sigma)[None, :] < l_miss[:, None]
    bad = rng.random(n - n_hit) < 0.25             # malformed quarter of misses
    kind = rng.integers(0, 4, n - n_hit)
    l_miss[bad & (kind == 0)] = 0                               # empty gram
    l_miss[bad & (kind == 1)] = sigma + 1                       # too long
    g_miss[bad & (kind == 2), 0] = vocab + 1                    # out of vocab
    g_miss[bad & (kind == 3), 0] = -7                           # negative id
    g = np.concatenate([g_hit, g_miss]).astype(np.int32)
    ln = np.concatenate([l_hit, l_miss]).astype(np.int32)
    return g, ln, rows


def expected_lookups(stats, g, ln, vocab: int) -> np.ndarray:
    """Exact host answers: the stats' count of each well-formed query, else 0."""
    sigma = g.shape[1]
    in_len = np.arange(sigma)[None, :] < ln[:, None]
    ok = ((ln >= 1) & (ln <= sigma)
          & np.all(np.where(in_len, (g >= 1) & (g <= vocab), True), axis=1))
    keys = row_keys(stats.lengths, stats.grams)          # canonical order: sorted
    q = row_keys(np.where(ok, ln, 0), np.where(in_len & ok[:, None], g, 0))
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    found = ok & (keys[pos] == q)
    return np.where(found, stats.counts[pos], 0)


def check_continuations(stats, idx, pg, pl, out) -> None:
    """n_distinct and total against the stats grouped by prefix; each top-k
    (term, cf) pair against a point lookup of prefix + term."""
    nd, total, terms, counts = (x.cpu().numpy() for x in out)
    sigma = stats.grams.shape[1]
    parent = stats.grams * (np.arange(sigma)[None, :] < (stats.lengths - 1)[:, None])
    pkeys = row_keys(stats.lengths, parent)
    uniq, inv, n_per = np.unique(pkeys, return_inverse=True, return_counts=True)
    mass = np.bincount(inv.reshape(-1), weights=stats.counts, minlength=len(uniq))
    q = row_keys(pl + 1, pg)
    pos = np.minimum(np.searchsorted(uniq, q), len(uniq) - 1)
    found = uniq[pos] == q
    check(np.array_equal(nd, np.where(found, n_per[pos], 0)), "continuation n_distinct")
    check(np.array_equal(total, np.where(found, mass[pos], 0).astype(np.int64)),
          "continuation total mass")
    check(np.all(np.diff(counts, axis=1) <= 0), "top-k counts descending")
    check(np.array_equal((counts > 0).sum(axis=1), np.minimum(nd, terms.shape[1])),
          "top-k fill")
    qi, kj = np.nonzero(counts > 0)
    g = pg[qi].copy()
    g[np.arange(len(qi)), pl[qi]] = terms[qi, kj]
    got = lookup(idx, g, pl[qi] + 1).cpu().numpy()
    check(np.array_equal(got, counts[qi, kj]), "top-k pairs == point lookups")


def profile_job(tokens, cfg, dev) -> None:
    """One more run of the job under ``torch.profiler``: device busy time by
    kernel, and the share of the wall time the card sat idle."""
    if not tokens.is_cuda:
        return
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_job(tokens, cfg, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    print(f"profile: job under torch.profiler {wall_ms:.1f} ms wall, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile:   device {ms:9.3f} ms  {name[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for ev in host:
        print(f"profile:   host {ev.self_cpu_time_total / 1e3:9.3f} ms self  "
              f"{ev.key[:60]} x{ev.count}")


def phase_main_path(dev, n_terms: int = MAIN_TERMS) -> dict:
    """The full-width slice through the entry points a user calls."""
    vocab = corpus.NYT.vocab_size
    t0 = time.perf_counter()
    toks = corpus.zipf_corpus(n_terms, corpus.NYT, seed=0, duplicate_frac=0.02)
    tokens = torch.as_tensor(toks, device=dev)
    print(f"main: corpus of {n_terms} NYT-profile terms, {toks.size} positions "
          f"with PAD separators, made in {time.perf_counter() - t0:.1f} s")
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=vocab)
    sync = torch.cuda.synchronize if tokens.is_cuda else (lambda: None)
    if tokens.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    sync()

    ops.launches.clear()
    t0 = time.perf_counter()
    stats = run_job(tokens, cfg, device=dev)            # cold: allocator grows
    job_cold_s = time.perf_counter() - t0
    job_s = wall_times(lambda: run_job(tokens, cfg, device=dev), sync, 5)
    tracer = trace.enable_tracing()
    again = run_job(tokens, cfg, device=dev)
    trace.disable_tracing()
    t0 = time.perf_counter()
    idx = build_index(stats, vocab_size=vocab, device=dev)
    sync()
    index_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    g, ln, hit_rows = lookup_batch(stats, rng, N_LOOKUPS, vocab)
    g_dev, ln_dev = torch.as_tensor(g, device=dev), torch.as_tensor(ln, device=dev)
    got = lookup(idx, g_dev, ln_dev)
    lookup_s = wall_times(lambda: lookup(idx, g_dev, ln_dev), sync, 20)

    p_rows = rng.integers(0, len(stats), N_PREFIXES)
    pl = np.minimum(stats.lengths[p_rows], rng.integers(0, SIGMA, N_PREFIXES)
                    ).astype(np.int32)
    pg = (stats.grams[p_rows] * (np.arange(SIGMA)[None, :] < pl[:, None])
          ).astype(np.int32)
    pg_dev, pl_dev = torch.as_tensor(pg, device=dev), torch.as_tensor(pl, device=dev)
    cont = continuations(idx, pg_dev, pl_dev, k=TOP_K)
    cont_s = wall_times(lambda: continuations(idx, pg_dev, pl_dev, k=TOP_K), sync, 20)
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() if tokens.is_cuda else 0

    # ---- checks ------------------------------------------------------------
    bc = np.bincount(toks, minlength=vocab + 1)
    want_terms = np.flatnonzero(bc[1:] >= TAU) + 1
    uni = stats.lengths == 1
    check(np.array_equal(stats.grams[uni, 0], want_terms)
          and np.array_equal(stats.counts[uni], bc[want_terms]),
          "unigram counts == bincount for every term with cf >= tau")
    got = got.cpu().numpy()
    check(np.array_equal(got[:len(hit_rows)], stats.counts[hit_rows]),
          "every sampled hit returns its NGramStats count")
    check(np.array_equal(got, expected_lookups(stats, g, ln, vocab)),
          "all 2**16 lookups == exact host answers")
    check_continuations(stats, idx, pg, pl, cont)
    check(all(np.array_equal(getattr(stats, f), getattr(again, f))
              for f in ("grams", "lengths", "counts"))
          and stats.counters == again.counters, "a repeated job gives the same output")

    profile_job(tokens, cfg, dev)

    spans: dict[str, float] = {}
    for ev in tracer.events:
        spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    n_real = int((toks != 0).sum())
    warm = float(np.median(job_s))
    print(f"main: job cold {job_cold_s:.3f} s; warm median {warm:.3f} s "
          f"(min {min(job_s):.3f}, max {max(job_s):.3f}, n={len(job_s)}) = "
          f"{n_real / warm:,.0f} terms/s ({toks.size / warm:,.0f} positions/s); "
          f"{len(stats)} n-grams (sigma={SIGMA}, tau={TAU}); counters {stats.counters}")
    print("main: spans of a traced warm run (ms, round.* synced) "
          + ", ".join(f"{k} {v:.1f}" for k, v in spans.items()))
    print(f"main: build_index {index_s:.3f} s, {idx.n_rows} rows in capacity "
          f"{idx.size}")
    for what, n_q, times in (("lookup", N_LOOKUPS, lookup_s),
                             (f"continuations k={TOP_K}", N_PREFIXES, cont_s)):
        med = float(np.median(times))
        print(f"main: {what}: batch of {n_q} median {med * 1e3:.3f} ms "
              f"(max {max(times) * 1e3:.3f}, n={len(times)}) = {n_q / med:,.0f} q/s")
    print(f"main: peak device memory {peak / 2**30:.2f} GiB; kernel launches "
          f"{launches}")
    print("main: checks passed (unigrams == bincount, hits, misses/malformed, "
          "continuation mass and top-k pairs, repeated job)")
    return dict(tokens=tokens, stats=stats, idx=idx, queries=(g_dev, ln_dev),
                prefixes=(pg_dev, pl_dev), launches=launches)


# --------------------------------------------------------------------- phase 4
def _probes(lo, hi, pos, steps: int) -> tuple[int, int]:
    """(total probes, distinct rows probed) of a bounded binary search, replayed
    from its answer: a step goes right exactly when mid < the final position."""
    lo, hi, pos = lo.to(torch.int64), hi.to(torch.int64), pos.to(torch.int64)
    mids = []
    for _ in range(steps):
        live = lo < hi
        mid = (lo + hi) // 2
        mids.append(mid[live])
        right = mid < pos
        lo = torch.where(live & right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    mids = torch.cat(mids)
    return int(mids.numel()), int(torch.unique(mids).numel())


def bound(bytes_moved: float, ops_done: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops_done / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_cases(dev):
    """(kernel name, kernel call, plain call) on ragged and corner inputs."""
    rng = np.random.default_rng(3)
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), device=dev, dtype=dt)  # noqa: E731
    cases = []
    for toks, sigma, vocab in (([5], 5, 20_000), ([0], 3, 7), ([1, 1], 64, 1),
                               (rng.integers(0, 4, 1001), 7, 3),
                               (rng.integers(0, 70_001, 777), 9, 70_000),
                               (rng.integers(0, 2**20, 513), 64, 2**30)):
        x = t(np.asarray(toks, np.int32))
        cases.append(("suffix_pack",
                      lambda x=x, s=sigma, v=vocab: ops.suffix_pack(x, sigma=s, vocab_size=v),
                      lambda x=x, s=sigma, v=vocab: ref.suffix_pack_ref(x, sigma=s, vocab_size=v)))
    for n, parts in ((1, 64), (1, 1), (257, 7), (300_001, 512), (5000, 4096)):
        keys = rng.integers(0, 2**32, n).astype(np.int64)
        keys[: min(n, 3)] = [2**32 - 1, 2**31, 0][: min(n, 3)]
        valid = rng.random(n) < 0.7
        k, v = t(keys), t(valid)
        cases.append(("hash_partition",
                      lambda k=k, v=v, p=parts: ops.hash_partition(k, v, n_parts=p),
                      lambda k=k, v=v, p=parts: ref.hash_partition_ref(k, v, p)))
    for n, length, vmax in ((1, 5, 9), (1000, 1, 3), (999, 100, 2), (4097, 5, 4)):
        a = rng.integers(0, vmax, (n, length)).astype(np.int32)
        a = t(a[np.lexsort(a.T[::-1])])
        cases.append(("lcp_boundary", lambda a=a: ops.lcp_boundary(a),
                      lambda a=a: ref.lcp_boundary_ref(a)))
    for r, n_l, q, upper in ((1, 1, 5, False), (1, 2, 5, True), (333, 3, 1000, False),
                             (333, 3, 1000, True), (4096, 4, 3000, True)):
        lanes = rng.integers(0, 40, (r, n_l + 1)).astype(np.int64) + 2**31
        lanes = lanes[np.lexsort(lanes[:, 1:].T[::-1])]
        queries = rng.integers(0, 44, (q, n_l)).astype(np.int64) + 2**31
        lo = rng.integers(0, r + 1, q)                 # includes lo == hi == r
        hi = np.where(rng.random(q) < 0.2, lo, np.minimum(lo + rng.integers(0, r + 1, q), r))
        view = t(lanes)[:, 1:]                          # a row-strided view
        args = (view, t(queries), t(lo.astype(np.int32)), t(hi.astype(np.int32)))
        cases.append(("bsearch", lambda a=args, u=upper: ops.bsearch(*a, upper=u),
                      lambda a=args, u=upper: ref.bsearch_ref(*a, upper=u)))
    return cases


def phase_kernels(dev, main: dict) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    vocab = corpus.NYT.vocab_size
    n_l = pack.n_lanes(SIGMA, vocab)
    tokens, idx = main["tokens"], main["idx"]
    n = tokens.shape[0]
    rows = []

    def measure(name, kernel, plain, bytes_moved, ops_done, shape):
        err = max_abs_err(kernel(), plain())
        check(err == 0, f"{name} kernel == plain version at {shape}")
        ms = cuda_ms(kernel) if tokens.is_cuda else float("nan")
        plain_ms = cuda_ms(plain) if tokens.is_cuda else float("nan")
        bound_ms, bound_by = bound(bytes_moved, ops_done)
        print(f"kernel {name} at {shape}: equal; {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}), library call: none")
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{name}.cu",
                    replaces=KERNELS[name], launches=main["launches"].get(name, 0),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)

    # the main path's own intermediates, rebuilt stage by stage
    rows.append(measure(
        "suffix_pack",
        lambda: ops.suffix_pack(tokens, sigma=SIGMA, vocab_size=vocab),
        lambda: ref.suffix_pack_ref(tokens, sigma=SIGMA, vocab_size=vocab),
        n * (4 + 8 * n_l), 6 * SIGMA * n, f"tokens [{n}] -> lanes [{n}, {n_l}]"))
    records, _ = suffix_sigma.make_records(tokens, sigma=SIGMA, vocab_size=vocab)
    records = stages.combine(records, n_l)
    live = records[:, n_l] > 0
    key = stages.partition_keys(records, n_l, kind="lead", vocab_size=vocab)
    rows.append(measure(
        "hash_partition",
        lambda: ops.hash_partition(key, live, n_parts=64),
        lambda: ref.hash_partition_ref(key, live, 64),
        n * (8 + 1 + 4) + 64 * 4, 10 * n, f"keys [{n}], 64 parts"))
    del key, live
    terms = pack.unpack_terms(stages.sort_stage(records, n_keys=n_l)[:, :n_l],
                              vocab_size=vocab, sigma=SIGMA)
    del records
    rows.append(measure(
        "lcp_boundary", lambda: ops.lcp_boundary(terms),
        lambda: ref.lcp_boundary_ref(terms),
        n * (4 * SIGMA + 4 + SIGMA), 3 * SIGMA * n, f"terms [{n}, {SIGMA}]"))
    del terms

    # bsearch as the point lookups call it (the row reported), and as the
    # continuation queries do
    steps = ref.search_steps(idx.size)
    g, ln = main["queries"]
    g, ln, valid = index_query._clean(idx, g, ln, lo_len=1)
    q_lanes = pack.pack_terms(g, vocab_size=vocab)
    lead = pack.lead_term(q_lanes[:, 0], vocab_size=vocab)
    lo, hi = index_query._bracket(idx, idx.fanout, ln, lead)
    pg, pl = main["prefixes"]
    pg, pl, _ = index_query._clean(idx, pg, pl, lo_len=0)
    p_lanes = pack.pack_terms(pg, vocab_size=vocab)
    p_lead = pack.lead_term(p_lanes[:, 0], vocab_size=vocab)
    c_lo, c_hi = index_query._bracket(idx, idx.cont_fanout, pl + 1, p_lead)
    shapes = (("lookup", idx.lanes, q_lanes, lo, hi, False),
              ("continuation lower", idx.cont_prefix, p_lanes, c_lo, c_hi, False),
              ("continuation upper", idx.cont_prefix, p_lanes, c_lo, c_hi, True))
    for label, lanes, q, b_lo, b_hi, upper in shapes:
        pos = ops.bsearch(lanes, q, b_lo, b_hi, upper=upper, steps=steps)
        probes, distinct = _probes(b_lo, b_hi, pos, steps)
        n_q = q.shape[0]
        row = measure(
            "bsearch",
            lambda l=lanes, q=q, a=b_lo, b=b_hi, u=upper: ops.bsearch(l, q, a, b, upper=u, steps=steps),
            lambda l=lanes, q=q, a=b_lo, b=b_hi, u=upper: ref.bsearch_ref(l, q, a, b, upper=u, steps=steps),
            n_q * (8 * n_l + 4 + 4 + 4) + distinct * 8 * n_l,
            probes * (2 * n_l + 4),
            f"{label}: index [{idx.size}, {n_l}], queries [{n_q}], {steps} steps, "
            f"{probes} probes of {distinct} distinct rows")
        if label == "lookup":
            rows.append(row)

    cases = edge_cases(dev)
    for name, kernel, plain in cases:
        check(max_abs_err(kernel(), plain()) == 0, f"{name} edge case")
    print(f"kernels: {len(cases)} edge cases equal their plain versions "
          "(N=1, ragged N, keys >= 2**31, lo == hi, empty brackets, upper, "
          "strided lanes, sigma=64)")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script checks the port on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    kbuild.entries()                                    # phase 1
    info = kbuild.build_info
    print(f"build: {len(info['compiled'])} kernels compiled in "
          f"{info['seconds']:.1f} s into {info['directory']}")
    for name, report in info["ptxas"].items():
        used = [ln.strip() for ln in report.splitlines() if "Used" in ln]
        print(f"build: {name}: {'; '.join(used)}")

    phase_oracle(dev)                                   # phase 2
    main_run = phase_main_path(dev)                     # phase 3
    missing = [k for k in KERNELS if main_run["launches"].get(k, 0) == 0]
    check(not missing, f"main path launched every kernel (missing {missing})")
    rows = phase_kernels(dev, main_run)                 # phase 4

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
