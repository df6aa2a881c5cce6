"""The cases of the port's streaming path across ranks against ``repro``'s
host mesh (``test_torch_mesh_waves.py`` runs them at 8 parts,
``test_torch_mesh_waves_3.py`` at 3): not collected itself.

The same seeded inputs go through ``repro`` on a host mesh of 8 and of 3
devices (subprocesses, as ``tests/test_distributed.py`` runs them) and
through the port on 8 and 3 gloo ranks on the CPU (``spawn_ranks`` with
``device="cpu"``).  Everything is compared exactly, every case at the same
number of parts:

  * the mesh waves of the four methods (sigma 4, tau 2, vocab 23,
    ``apriori_index_k=2``, ``test_distributed.py``'s 400-token corpus) in
    waves of 97, 5 and the corpus + 5, under the three accumulators, with
    the fold thread and without: the stats equal ``repro``'s and the
    monolithic job's, and the counters dict (``jobs``, ``map_records``,
    ``shuffle_records``, ``shuffle_bytes``, ``waves``, ``fold_rows``,
    ``retries``) equals ``repro``'s run with ``overlap=False`` (with the
    fold thread, ``repro``'s ``retries`` depends on thread timing);
  * the tight-capacity case: ``retries`` at least 1 and ``repro``'s, every
    other counter and the stats the ample run's;
  * the skew histogram measured only while a metrics registry is set (here
    on rank 0 alone), to ``repro``'s value;
  * one ``wave.mesh.dispatch`` and one ``wave.mesh.collect`` span a wave;
  * ``iter_wave_stats`` on a mesh: each wave's partial on one device's;
  * ``run_streaming`` on a mesh: its ingest reports and its answers equal
    ``repro``'s single-device ``run_streaming``;
  * ``shard_generational`` of a generational index grown through four
    ingests with a compaction, flat and compressed: every gram, a
    miss-heavy batch, continuations with length-0 prefixes and
    ``describe_topology`` (but the resident ``nbytes``); the incremental
    re-shard's builds and reuses (``prev=``), and a block-size change that
    reuses nothing, both answering as the index on one device;
  * ``StreamingNGramService(mesh=)`` with and without ``wave_tokens``: its
    ingest reports and answers equal ``repro``'s service on the mesh.

``repro``'s ``ShardedGenerationalIndex`` has no ``n_parts``, which its own
``describe_topology`` reads; the ``repro`` side below lends it one (the
mesh's size) to describe it.  The ranks' function lives here, so this
module imports no JAX at its top: each rank imports it to find it.  Each
test file computes its own number of parts (one ``repro`` subprocess and
one spawn of ranks), so that a parallel run spreads them over its
workers; ``repro``'s single-device ``run_streaming`` runs in the test's
process.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import NGramConfig, run_job
from repro_torch.index import (GenerationalIndex, continuations, lookup,
                               serve_queries, shard_generational)
from repro_torch.index.serve import describe_topology
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.obs import metrics, trace
from repro_torch.pipeline import WaveExecutor
from repro_torch.serve.service import StreamingNGramService

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take their cores.
torch.set_num_threads(1)

PARTS = (8, 3)
METHODS = ("suffix_sigma", "naive", "apriori_scan", "apriori_index")
ACCUMULATORS = ("defer", "tiered", "pairwise")
WAVE_CFG = dict(sigma=4, tau=2, vocab_size=23, apriori_index_k=2)
TIGHT_CFG = dict(sigma=3, tau=1, vocab_size=2, combine=False)
SKEW_CFG = dict(sigma=3, tau=1, vocab_size=64)
STREAM_CFG = dict(sigma=4, tau=1, vocab_size=40)
SERVICE_CFG = dict(sigma=4, tau=2, vocab_size=40, combine_route="hash")
GEN_VOCAB, GEN_SIGMA, TOP_K = 40, 4, 8
LAYOUTS = ("flat", "compressed")
QUERIES = ("all", "miss", "cont")


def wave_sizes(n: int) -> tuple:
    """A partial last wave, a wave smaller than the mesh, one wave."""
    return (97, 5, n + 5)


def overlaps(wave: int, accumulator: str) -> tuple:
    """The fold thread on and off; in the 80 waves of 5 tokens, on for
    ``defer``, off for ``pairwise`` and both for ``tiered`` (whose fold
    thread asks the feeder for rung sizes), to keep the file's time."""
    if wave != 5 or accumulator == "tiered":
        return (True, False)
    return (accumulator == "defer",)


REPRO_CODE = """
import json, numpy as np, jax
from repro.core import run_job
from repro.core.stats import NGramConfig
from repro.index import (GenerationalIndex, continuations, lookup, serve_queries,
                         shard_generational)
from repro.index.serve import ShardedGenerationalIndex, describe_topology
from repro.obs import metrics as obs_metrics
from repro.pipeline import WaveExecutor
from repro.serve.service import StreamingNGramService
mesh = jax.make_mesh(({n},), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
inp = dict(np.load({inputs!r}))
consts = json.loads({consts!r})
out, meta = {{}}, {{"counters": {{}}}}

def keep(name, st):
    out[name + "/grams"], out[name + "/lengths"], out[name + "/counts"] = (
        st.grams, st.lengths, st.counts)
    meta["counters"][name] = {{k: float(v) for k, v in st.counters.items()}}

toks = inp["waves"]
for m in consts["methods"]:
    cfg = NGramConfig(method=m, **consts["wave_cfg"])
    for wave in consts["waves"]:
        # one executor a (method, wave) keeps its compiled programs; the
        # sticky capacity scale starts afresh each run, as a new executor's
        ex = WaveExecutor(cfg, wave_tokens=wave, mesh=mesh, overlap=False)
        for acc in consts["accumulators"]:
            ex.accumulator, ex._mesh_scale = acc, 1
            keep(f"{{m}}/{{wave}}/{{acc}}", ex.run(toks))
for name, cf in (("ample", 50.0), ("tight", 0.05)):
    keep(name, WaveExecutor(NGramConfig(capacity_factor=cf, **consts["tight_cfg"]),
                            wave_tokens=600, mesh=mesh, overlap=False).run(inp["tight"]))
skew_cfg = NGramConfig(**consts["skew_cfg"])
keep("skew_off", WaveExecutor(skew_cfg, wave_tokens=200, mesh=mesh,
                              overlap=False).run(inp["skew"]))
obs_metrics.set_registry(obs_metrics.MetricsRegistry())
keep("skew_on", WaveExecutor(skew_cfg, wave_tokens=200, mesh=mesh,
                             overlap=False).run(inp["skew"]))
obs_metrics.set_registry(None)

# the service on the mesh, with and without waves
for name, wave in (("svc_waves", consts["svc_wave"]), ("svc_job", None)):
    svc = StreamingNGramService(NGramConfig(**consts["svc_cfg"]), compress=True,
                                wave_tokens=wave, mesh=mesh)
    meta[name] = []
    for i in range(consts["svc_parts"]):
        rep = svc.ingest(inp[f"svc{{i}}"])
        meta[name].append({{k: rep[k] for k in consts["report_keys"]}})
    out[name + "/lookup"] = svc.lookup(inp["svc_g"], inp["svc_l"])
    out[name + "/cont"] = svc.continuations(inp["svc_pg"], inp["svc_pl"], k={k})

# the sharded generational index, both layouts
ShardedGenerationalIndex.n_parts = property(lambda s: s.mesh.shape[s.axis_name])
cfg1 = NGramConfig(sigma={sigma}, tau=1, vocab_size={vocab})
gen_stats = [run_job(inp[f"gen{{i}}"], cfg1) for i in range(4)]
meta["topology"] = {{}}
for layout in ("flat", "compressed"):
    gen = GenerationalIndex(sigma={sigma}, vocab_size={vocab}, compress=layout == "compressed")
    meta["merges_" + layout] = sum(gen.ingest(s)["merges"] for s in gen_stats)
    sh = shard_generational(gen, mesh=mesh)
    out[layout + "/all"] = serve_queries(sh, inp["all_g"], inp["all_l"])
    out[layout + "/miss"] = serve_queries(sh, inp["miss_g"], inp["miss_l"])
    out[layout + "/cont"] = serve_queries(sh, inp["cont_g"], inp["cont_l"],
                                          mode="continuations", k={k})
    meta["topology"][layout] = describe_topology(sh)

# incremental re-sharding: builds and reuses
reg = obs_metrics.MetricsRegistry()
obs_metrics.set_registry(reg)
gen = GenerationalIndex(sigma={sigma}, vocab_size={vocab}, compress=True)
for i in range(3):
    gen.ingest(run_job(inp[f"base{{i}}"], cfg1))
sh1 = shard_generational(gen, mesh=mesh)
counts = [dict(reg.snapshot()["counters"])]
gen.ingest(run_job(inp["delta"], cfg1))
sh2 = shard_generational(gen, mesh=mesh, prev=sh1)
counts.append(dict(reg.snapshot()["counters"]))
sh3 = shard_generational(gen, mesh=mesh, prev=sh2, block_size=8)
counts.append(dict(reg.snapshot()["counters"]))
obs_metrics.set_registry(None)
meta["reuse"] = [{{k: c.get(k, 0) for k in ("serve.shard_builds", "serve.shard_reuses")}}
                 for c in counts]
meta["reuse_segments"] = [sh1.n_segments, sh2.n_segments, sh3.n_segments]
np.savez({out!r}, **out)
json.dump(meta, open({meta!r}, "w"))
print("OK")
"""

REPORT_KEYS = ("ingested_rows", "merges", "segment_rows", "waves")
STREAM_WAVE = 300
SVC_WAVE = 700
SVC_PARTS = 4


def _grams_of(stats) -> tuple[np.ndarray, np.ndarray]:
    return stats.grams.astype(np.int32), stats.lengths.astype(np.int32)


def _prefixes(stats, rng, n: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` prefixes of the grams of ``stats`` (lengths 0 .. sigma - 1,
    the first 3 of length 0)."""
    rows = rng.integers(0, len(stats), n)
    pl = np.minimum(stats.lengths[rows], rng.integers(0, stats.grams.shape[1], n))
    pl[:3] = 0
    pg = stats.grams[rows] * (np.arange(stats.grams.shape[1])[None, :] < pl[:, None])
    return pg.astype(np.int32), pl.astype(np.int32)


def _inputs() -> dict:
    """Every case's input, made from seeds (``make_corpus`` is
    ``tests/test_compress.py``'s)."""
    from test_compress import make_corpus
    inp = dict(waves=make_corpus(400, 23, "zipf", seed=7),
               spans=make_corpus(400, 23, "zipf", seed=5),
               tight=np.random.default_rng(1).integers(0, 3, 2400).astype(np.int32),
               skew=np.random.default_rng(3).integers(1, 40, 800).astype(np.int32),
               stream=make_corpus(3000, 40, "zipf", seed=11))
    # run_streaming's queries: the tau = 1 job's grams, and prefixes of them
    st = run_job(inp["stream"], NGramConfig(**STREAM_CFG), device="cpu")
    inp["stream_g"], inp["stream_l"] = _grams_of(st)
    inp["stream_pg"], inp["stream_pl"] = _prefixes(st, np.random.default_rng(4), 200)
    # the service: a 60 % base and 3 deltas
    svc_toks = make_corpus(4000, GEN_VOCAB, "zipf", seed=21)
    base, rest = np.split(svc_toks, [int(len(svc_toks) * 0.6)])
    for i, part in enumerate([base] + np.array_split(rest, SVC_PARTS - 1)):
        inp[f"svc{i}"] = part
    st = run_job(svc_toks, NGramConfig(**SERVICE_CFG), device="cpu")
    inp["svc_g"], inp["svc_l"] = _grams_of(st)
    inp["svc_pg"], inp["svc_pl"] = _prefixes(st, np.random.default_rng(5), 200)
    # the generational index of test_distributed.py's sharded cases
    cfg1 = NGramConfig(sigma=GEN_SIGMA, tau=1, vocab_size=GEN_VOCAB)
    gen_stats = []
    for i, n in enumerate((5000, 1100, 1100, 1100)):
        inp[f"gen{i}"] = make_corpus(n, GEN_VOCAB, "zipf", 40 + i)
        gen_stats.append(run_job(inp[f"gen{i}"], cfg1, device="cpu"))
    for i, n in enumerate((4000, 900, 900)):
        inp[f"base{i}"] = make_corpus(n, GEN_VOCAB, "zipf", 60 + i)
    inp["delta"] = make_corpus(120, GEN_VOCAB, "zipf", 99)
    union = run_job(np.concatenate([np.concatenate([inp[f"gen{i}"], [0]])
                                    for i in range(4)]), cfg1, device="cpu")
    inp["all_g"], inp["all_l"] = _grams_of(union)
    rng = np.random.default_rng(0)
    inp["miss_l"] = rng.integers(1, GEN_SIGMA + 1, 2000).astype(np.int32)
    miss_g = rng.integers(1, GEN_VOCAB + 1, (2000, GEN_SIGMA)).astype(np.int32)
    inp["miss_g"] = miss_g * (np.arange(GEN_SIGMA)[None, :] < inp["miss_l"][:, None])
    inp["cont_g"], inp["cont_l"] = _prefixes(union, rng, 15)
    return inp


def _stats_out(st) -> tuple:
    return st.grams, st.lengths, st.counts, dict(st.counters)


def _port_cases(mesh, inp: dict) -> dict:
    """Every case on this rank (runs in each spawned rank)."""
    out = {"waves": {}}
    toks = inp["waves"]
    for m in METHODS:
        cfg = NGramConfig(method=m, **WAVE_CFG)
        for wave in wave_sizes(len(toks)):
            for acc in ACCUMULATORS:
                for overlap in overlaps(wave, acc):
                    out["waves"][m, wave, acc, overlap] = _stats_out(WaveExecutor(
                        cfg, wave_tokens=wave, mesh=mesh, accumulator=acc,
                        overlap=overlap, device="cpu").run(toks))
    for name, cf in (("ample", 50.0), ("tight", 0.05)):
        for overlap in (True, False):
            out[name, overlap] = _stats_out(WaveExecutor(
                NGramConfig(capacity_factor=cf, **TIGHT_CFG), wave_tokens=600,
                mesh=mesh, overlap=overlap, device="cpu").run(inp["tight"]))
    skew_cfg = NGramConfig(**SKEW_CFG)
    out["skew_off"] = _stats_out(WaveExecutor(skew_cfg, wave_tokens=200, mesh=mesh,
                                              device="cpu").run(inp["skew"]))
    if mesh.rank == 0:                     # one rank's registry turns it on
        metrics.set_registry(metrics.MetricsRegistry())
    out["skew_on"] = _stats_out(WaveExecutor(skew_cfg, wave_tokens=200, mesh=mesh,
                                             device="cpu").run(inp["skew"]))
    metrics.set_registry(None)

    # spans: apriori_scan (several rounds) in 8 waves, traced after a warm run
    ex = WaveExecutor(NGramConfig(method="apriori_scan", **WAVE_CFG),
                      wave_tokens=-(-len(inp["spans"]) // 8), mesh=mesh, device="cpu")
    ex.run(inp["spans"])
    tracer = trace.enable_tracing()
    try:
        ex.run(inp["spans"])
    finally:
        trace.disable_tracing()
    out["spans"] = [e["name"] for e in tracer.events]

    # the per-wave partials (iter_wave_stats), every wave's rows on every rank
    out["iter"] = [_stats_out(st) for st in WaveExecutor(
        NGramConfig(method="apriori_scan", **WAVE_CFG), wave_tokens=97, mesh=mesh,
        device="cpu").iter_wave_stats(toks)]

    # run_streaming on the mesh
    gen, reports = WaveExecutor(NGramConfig(**STREAM_CFG), wave_tokens=STREAM_WAVE,
                                mesh=mesh, device="cpu").run_streaming(
                                    inp["stream"], compress=True)
    nd, tot, terms, counts = continuations(gen, inp["stream_pg"], inp["stream_pl"],
                                           k=TOP_K)
    out["stream"] = dict(
        reports=[{k: r[k] for k in ("ingested_rows", "merges", "segment_rows")}
                 for r in reports],
        lookup=lookup(gen, inp["stream_g"], inp["stream_l"]).numpy(),
        cont=torch.cat([nd[:, None], tot[:, None], terms, counts], 1).numpy())

    # the service on the mesh, with and without waves
    for name, wave in (("svc_waves", SVC_WAVE), ("svc_job", None)):
        svc = StreamingNGramService(NGramConfig(**SERVICE_CFG), compress=True,
                                    wave_tokens=wave, mesh=mesh, device="cpu")
        reports = [svc.ingest(inp[f"svc{i}"]) for i in range(SVC_PARTS)]
        out[name] = ([{k: r[k] for k in REPORT_KEYS} for r in reports],
                     svc.lookup(inp["svc_g"], inp["svc_l"]),
                     svc.continuations(inp["svc_pg"], inp["svc_pl"], k=TOP_K))

    # the sharded generational index
    cfg1 = NGramConfig(sigma=GEN_SIGMA, tau=1, vocab_size=GEN_VOCAB)
    gen_stats = [run_job(inp[f"gen{i}"], cfg1, device="cpu") for i in range(4)]
    out["gen"] = {}
    for layout in LAYOUTS:
        gen = GenerationalIndex(sigma=GEN_SIGMA, vocab_size=GEN_VOCAB,
                                compress=layout == "compressed", device="cpu")
        merges = sum(gen.ingest(s)["merges"] for s in gen_stats)
        sh = shard_generational(gen, mesh=mesh)
        out["gen"][layout] = dict(
            merges=merges, n_segments=(sh.n_segments, gen.n_segments),
            all=serve_queries(sh, inp["all_g"], inp["all_l"]),
            miss=serve_queries(sh, inp["miss_g"], inp["miss_l"]),
            cont=serve_queries(sh, inp["cont_g"], inp["cont_l"],
                               mode="continuations", k=TOP_K),
            topology=describe_topology(sh))

    # incremental re-sharding
    reg = metrics.MetricsRegistry()
    metrics.set_registry(reg)
    gen = GenerationalIndex(sigma=GEN_SIGMA, vocab_size=GEN_VOCAB, compress=True,
                            device="cpu")
    for i in range(3):
        gen.ingest(run_job(inp[f"base{i}"], cfg1, device="cpu"))
    sh1 = shard_generational(gen, mesh=mesh)
    counts = [reg.snapshot()["counters"]]
    delta_merges = gen.ingest(run_job(inp["delta"], cfg1, device="cpu"))["merges"]
    sh2 = shard_generational(gen, mesh=mesh, prev=sh1)
    counts.append(reg.snapshot()["counters"])
    sh3 = shard_generational(gen, mesh=mesh, prev=sh2, block_size=8)
    counts.append(reg.snapshot()["counters"])
    metrics.set_registry(None)
    out["reuse"] = dict(
        counts=[{k: c.get(k, 0) for k in ("serve.shard_builds", "serve.shard_reuses")}
                for c in counts],
        segments=[sh1.n_segments, sh2.n_segments, sh3.n_segments],
        delta_merges=delta_merges,
        elders_reused=all(a is b for a, b in zip(sh2.shards[1:], sh1.shards)),
        new_built=all(sh2.shards[0] is not s for s in sh1.shards),
        ids=(sh2.level_ids[1:] == sh1.level_ids),
        none_reused=all(a is not b for a in sh3.shards for b in sh2.shards),
        lookup=serve_queries(sh2, inp["all_g"], inp["all_l"]),
        lookup8=serve_queries(sh3, inp["all_g"], inp["all_l"]),
        want=lookup(gen, inp["all_g"], inp["all_l"]).numpy())
    return out


def _repro_streaming(inp: dict) -> tuple[dict, list]:
    """``repro``'s single-device ``run_streaming`` of ``inp["stream"]`` and
    its answers, in this process (one device needs no host mesh)."""
    from repro.core.stats import NGramConfig as JConfig
    from repro.index import continuations as jcontinuations, lookup as jlookup
    from repro.pipeline import WaveExecutor as JWaveExecutor
    gen, reports = JWaveExecutor(JConfig(**STREAM_CFG), wave_tokens=STREAM_WAVE
                                 ).run_streaming(inp["stream"], compress=True)
    nd, tot, terms, counts = (np.asarray(x) for x in jcontinuations(
        gen, inp["stream_pg"], inp["stream_pl"], k=TOP_K))
    want = {"lookup": np.asarray(jlookup(gen, inp["stream_g"], inp["stream_l"])),
            "cont": np.concatenate([nd[:, None], tot[:, None], terms, counts], axis=1)}
    return want, [{k: r[k] for k in ("ingested_rows", "merges", "segment_rows")}
                  for r in reports]


def build_runs(tmp_path_factory, parts: tuple) -> dict:
    """{P: (repro arrays, repro meta, the port's results of every rank,
    inputs)} for each P of ``parts``, and ``repro``'s single-device
    ``run_streaming`` under key 1 (its answers, its reports).  Each host
    mesh of ``repro`` runs in a subprocess on a thread while the port's
    ranks run."""
    pytest.importorskip("jax")
    from test_distributed import run_with_devices
    tmp = tmp_path_factory.mktemp("mesh_waves")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    consts = json.dumps(dict(
        methods=METHODS, wave_cfg=WAVE_CFG, waves=wave_sizes(len(inp["waves"])),
        accumulators=ACCUMULATORS, tight_cfg=TIGHT_CFG, skew_cfg=SKEW_CFG,
        svc_cfg=SERVICE_CFG, svc_wave=SVC_WAVE, svc_parts=SVC_PARTS,
        report_keys=REPORT_KEYS))
    codes = {n: REPRO_CODE.format(n=n, inputs=str(tmp / "inputs.npz"), consts=consts,
                                  k=TOP_K, sigma=GEN_SIGMA, vocab=GEN_VOCAB,
                                  out=str(tmp / f"repro{n}.npz"),
                                  meta=str(tmp / f"repro{n}.json"))
             for n in parts}
    errors: dict = {}

    def repro(n):
        errors[n] = None
        try:
            run_with_devices(codes[n], n)
        except BaseException as e:              # re-raised below, on the test's thread
            errors[n] = e

    threads = [threading.Thread(target=repro, args=(n,)) for n in codes]
    for t in threads:
        t.start()
    port = {n: spawn_ranks(n, _port_cases, inp, device="cpu") for n in parts}
    out = {1: _repro_streaming(inp) + (None, inp)}
    for t in threads:
        t.join()
    for n in codes:
        if errors[n] is not None:
            raise errors[n]
        out[n] = (dict(np.load(tmp / f"repro{n}.npz")),
                  json.load(open(tmp / f"repro{n}.json")), port[n], inp)
    return out


def _same_on_every_rank(ranks: list, get):
    """The rank 0 value of ``get``, after checking every rank's equals it."""
    first = get(ranks[0])
    for r in ranks[1:]:
        other = get(r)
        for a, b in zip(first, other):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
    return first


def _assert_stats(got: tuple, want: dict, name: str):
    for i, f in enumerate(("grams", "lengths", "counts")):
        assert np.array_equal(got[i], want[f"{name}/{f}"]), f


def mesh_wave_tests(parts: tuple) -> dict:
    """The tests of the cases run on ``parts`` ranks (and ``repro``'s mesh
    of as many devices), by name: a test file takes them into its
    namespace beside a module fixture ``runs`` of :func:`build_runs`."""
    @pytest.mark.parametrize("n", parts)
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("accumulator", ACCUMULATORS)
    def test_mesh_waves_equal_repro_and_the_monolithic_job(runs, n, method, accumulator):
        want, meta, ranks, inp = runs[n]
        mono = run_job(inp["waves"], NGramConfig(method=method, **WAVE_CFG), device="cpu")
        for wave in wave_sizes(len(inp["waves"])):
            name = f"{method}/{wave}/{accumulator}"
            for overlap in overlaps(wave, accumulator):
                got = _same_on_every_rank(
                    ranks, lambda r: r["waves"][method, wave, accumulator, overlap])
                _assert_stats(got, want, name)
                for i, f in enumerate(("grams", "lengths", "counts")):
                    assert np.array_equal(got[i], getattr(mono, f)), f
                assert got[3] == meta["counters"][name], (name, overlap)
                assert got[3]["waves"] == -(-len(inp["waves"]) // wave)
                assert got[3]["jobs"] > 0 and len(got[1]) > 0


    @pytest.mark.parametrize("n", parts)
    def test_tight_capacity_retries_as_repro(runs, n):
        want, meta, ranks, _ = runs[n]
        for overlap in (True, False):
            tight = _same_on_every_rank(ranks, lambda r: r["tight", overlap])
            ample = _same_on_every_rank(ranks, lambda r: r["ample", overlap])
            _assert_stats(tight, want, "tight")
            _assert_stats(ample, want, "ample")
            assert tight[3]["retries"] >= 1 and ample[3]["retries"] == 0
            assert tight[3] == meta["counters"]["tight"]
            assert ample[3] == meta["counters"]["ample"]
            assert tight[3]["overflow"] == 0
            for k in ("jobs", "map_records", "shuffle_records", "shuffle_bytes", "waves",
                      "fold_rows"):
                assert tight[3][k] == ample[3][k], k


    @pytest.mark.parametrize("n", parts)
    def test_skew_measured_only_with_a_registry(runs, n):
        want, meta, ranks, _ = runs[n]
        off = _same_on_every_rank(ranks, lambda r: r["skew_off"])
        on = _same_on_every_rank(ranks, lambda r: r["skew_on"])
        assert off[3]["shuffle_skew"] == 0.0 < on[3]["shuffle_skew"]
        assert off[3] == meta["counters"]["skew_off"]
        assert on[3] == meta["counters"]["skew_on"]
        _assert_stats(on, want, "skew_on")
        _assert_stats(off, want, "skew_off")


    @pytest.mark.parametrize("n", parts)
    def test_one_dispatch_and_one_collect_span_a_wave(runs, n):
        for r in runs[n][2]:
            names = r["spans"]
            assert names.count("wave.mesh.dispatch") == 8
            assert names.count("wave.mesh.collect") == 8
            assert names.count("wave.mesh.retry") == 0
            assert names.count("wave.fold") == 8
            assert names.count("wave.run") == 1
            assert names.count("wave.submit") == 0


    @pytest.mark.parametrize("n", parts)
    def test_iter_wave_stats_equal_one_device(runs, n):
        """Each wave's partial (``tau = 1``) on a mesh equals the wave's on one
        device, rows and counters but the shuffle's (each rank combines its own
        records), on every rank."""
        inp, ranks = runs[n][3], runs[n][2]
        one = list(WaveExecutor(NGramConfig(method="apriori_scan", **WAVE_CFG),
                                wave_tokens=97, device="cpu").iter_wave_stats(inp["waves"]))
        assert len(one) == -(-len(inp["waves"]) // 97)
        for r in ranks:
            assert len(r["iter"]) == len(one)
            for got, want in zip(r["iter"], one):
                for a, f in zip(got[:3], ("grams", "lengths", "counts")):
                    assert np.array_equal(a, getattr(want, f)), f
                for k in ("jobs", "map_records"):
                    assert got[3][k] == want.counters[k], k


    @pytest.mark.parametrize("n", parts)
    def test_run_streaming_equals_repro_on_one_device(runs, n):
        want, reports = runs[1][0], runs[1][1]
        for r in runs[n][2]:
            got = r["stream"]
            assert got["reports"] == reports
            assert np.array_equal(got["lookup"], want["lookup"])
            assert np.array_equal(got["cont"], want["cont"])
        assert len(reports) == -(-3000 // STREAM_WAVE)
        assert sum(rep["merges"] for rep in reports) >= 1


    @pytest.mark.parametrize("n", parts)
    @pytest.mark.parametrize("wave", ["svc_waves", "svc_job"])
    def test_service_with_a_mesh_equals_repro(runs, n, wave):
        want, meta, ranks, inp = runs[n]
        reports, look, cont = _same_on_every_rank(ranks, lambda r: r[wave])
        assert reports == meta[wave]
        assert np.array_equal(look, want[wave + "/lookup"])
        assert np.array_equal(cont, want[wave + "/cont"])
        assert (look > 0).mean() > 0.5 and sum(rep["merges"] for rep in reports) >= 1


    @pytest.mark.parametrize("n", parts)
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("query", QUERIES)
    def test_shard_generational_serves_as_repro(runs, n, layout, query):
        want, meta, ranks, inp = runs[n]
        for r in ranks:
            got = r["gen"][layout]
            assert got["merges"] == meta["merges_" + layout] >= 1
            assert got["n_segments"][0] == got["n_segments"][1] >= 2
            assert np.array_equal(got[query], want[f"{layout}/{query}"])
        if query == "miss":
            assert 0 < (got["miss"] > 0).mean() < 0.5
        if query == "cont":
            assert (got["cont"][inp["cont_l"] == 0] == got["cont"][0]).all()


    @pytest.mark.parametrize("n", parts)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_sharded_generational_topology_equal_repro_but_resident_bytes(runs, n, layout):
        """Equal to ``repro``'s but the ``nbytes`` of the index and of each
        segment: the port's resident bytes count int64 lanes and caches."""
        _, meta, ranks, _ = runs[n]

        def strip(topology: dict) -> dict:
            out = {k: v for k, v in topology.items() if k != "nbytes"}
            out["segments"] = [{k: v for k, v in s.items() if k != "nbytes"}
                               for s in topology["segments"]]
            return out

        want = meta["topology"][layout]
        for r in ranks:
            got = r["gen"][layout]["topology"]
            assert got["kind"] == "sharded_generational" and got["n_parts"] == n
            assert got["nbytes"] == sum(s["nbytes"] for s in got["segments"]) > 0
            assert len(got["segments"]) >= 2
            assert strip(got) == strip(want)


    @pytest.mark.parametrize("n", parts)
    def test_shard_generational_reuses_levels_as_repro(runs, n):
        want, meta, ranks, _ = runs[n]
        for r in ranks:
            got = r["reuse"]
            assert got["delta_merges"] == 0
            assert got["segments"] == meta["reuse_segments"]
            assert got["segments"][1] == got["segments"][0] + 1
            assert got["elders_reused"] and got["new_built"] and got["ids"]
            assert got["none_reused"]
            assert np.array_equal(got["lookup"], got["want"])
            assert np.array_equal(got["lookup8"], got["want"])
        # rank 0 counts, as repro's one controller does
        assert ranks[0]["reuse"]["counts"] == meta["reuse"]
        assert meta["reuse"][1]["serve.shard_builds"] - meta["reuse"][0]["serve.shard_builds"] == 1
        assert all(c == {"serve.shard_builds": 0, "serve.shard_reuses": 0}
                   for r in ranks[1:] for c in r["reuse"]["counts"])

    return {name: fn for name, fn in locals().items() if name.startswith("test_")}
