"""The port's paths on the card against the same calls on the CPU.

Each case draws a corpus from ``repro_torch.data.corpus`` with a seed, runs
one path of the port on the card and on ``device="cpu"`` (the kernels'
plain versions), and requires every output to be equal: the four n-gram
methods, ``decode_segment`` of a compressed index, ``merge_segments`` on the
``"merge"`` route, a compressed ``GenerationalIndex`` through its
compactions, the paper's extensions (the time-series job on both
combine routes, maximal / closed filtering, document frequencies, postings
and the two-phase sigma split), the wave engine (each method's wave run,
``run_streaming``, a wave dispatch with no host sync), and the serving
frontend (HTTP bodies of a service on the card against one on the CPU, the
card's searches launched from the batcher's thread), and the multi-rank
batch path (two gloo ranks sharing the card: the four methods and the
sharded index), and the streaming path across ranks (two gloo ranks sharing
the card against two on the CPU: the mesh waves, ``run_streaming`` and
``shard_generational``), and LM serving and training (each reduced
arch's prefill and decode steps, and one train step, card against CPU in
float32), and the recsys and GNN archs (one train step of each reduced
config, card against CPU in float32).  ``merge_path`` is
also held against its plain version at runs above 2**26 rows.  The file
imports no JAX: it runs on a GPU host that has none, and every case skips
without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (METHODS, NGramConfig, aggregations, extensions_filter,
                              run_job, suffix_sigma)
from repro_torch.data import corpus
from repro_torch.index import (GenerationalIndex, build_compressed_index,
                               decode_segment, lookup, merge_segments,
                               segment_from_stats)
from repro_torch.kernels import ops, ref
from repro_torch.pipeline import WaveExecutor

SIGMA, TAU = 5, 2
VOCAB = corpus.NYT.vocab_size


# the LM archs of the registry (which also holds the GNN and recsys archs)
LM_ARCHS = ["deepseek-moe-16b", "llama3.2-1b", "minicpm3-4b", "mixtral-8x7b",
            "phi3-medium-14b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def draw(n: int, seed: int) -> np.ndarray:
    return corpus.zipf_corpus(n, corpus.NYT, seed=seed, duplicate_frac=0.05)


def cpu_stats(n: int, seed: int):
    return run_job(draw(n, seed), NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB),
                   device="cpu")


def assert_same_stats(got, want):
    for field in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.counters == want.counters


def assert_equal_on_host(a, b):
    """Every field of two port index objects (dataclasses) is equal, tensors
    compared on the host."""
    assert type(a) is type(b)
    for name, x in vars(a).items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.cpu(), y.cpu()), name
        elif hasattr(x, "__dataclass_fields__"):
            assert_equal_on_host(x, y)
        else:
            assert x == y, name


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_methods_match_cpu(cuda_device, method):
    """Grams, lengths, counts and every counter of each method's job."""
    toks = draw(40_000, 3)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method,
                      apriori_index_k=2)
    got = run_job(toks, cfg, device=cuda_device)
    want = run_job(toks, cfg, device="cpu")
    for field in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.counters == want.counters


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [4, 16])
def test_cuda_decode_segment_matches_cpu(cuda_device, block_size):
    stats = cpu_stats(30_000, 5)
    got = decode_segment(build_compressed_index(
        stats, vocab_size=VOCAB, block_size=block_size, device=cuda_device))
    want = decode_segment(build_compressed_index(
        stats, vocab_size=VOCAB, block_size=block_size, device="cpu"))
    assert_equal_on_host(got, want)


@pytest.mark.cuda
def test_cuda_merge_segments_matches_cpu(cuda_device):
    parts = [cpu_stats(n, seed) for n, seed in ((30_000, 6), (8_000, 7), (8_000, 8))]
    got = merge_segments([segment_from_stats(s, vocab_size=VOCAB, device=cuda_device)
                          for s in parts], route="merge")
    want = merge_segments([segment_from_stats(s, vocab_size=VOCAB, device="cpu")
                           for s in parts], route="merge")
    assert got.keys.is_cuda
    assert_equal_on_host(got, want)


@pytest.mark.cuda
def test_cuda_generational_compaction_matches_cpu(cuda_device):
    """The same merges and rungs after every ingest, and after
    ``compact_all``, on a compressed index with the default route."""
    gens = [GenerationalIndex(sigma=SIGMA, vocab_size=VOCAB, compress=True,
                              device=dev) for dev in (cuda_device, "cpu")]
    for i, n in enumerate((24_000, 6_000, 6_000, 6_000)):
        stats = cpu_stats(n, 10 + i)
        reports = [g.ingest(stats) for g in gens]
        assert reports[0] == reports[1]
        for a, b in zip(*(g.segments for g in gens)):
            assert_equal_on_host(a, b)
    for g in gens:
        g.compact_all()
    (got,), (want,) = (g.segments for g in gens)
    assert_equal_on_host(got, want)
    assert gens[0].compaction_stats == gens[1].compaction_stats


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["sort", "hash"])
def test_cuda_series_job_matches_cpu(cuda_device, route):
    """``run_job(..., bucket_ids=)`` with 21 year buckets: the records'
    bucket column from ``suffix_pack``, the combiner keyed on lanes |
    bucket, and the per-bucket run totals."""
    toks, years = corpus.zipf_corpus(40_000, corpus.NYT, seed=3, duplicate_frac=0.05,
                                     with_years=True)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, n_buckets=21,
                      combine_route=route)
    got = run_job(toks, cfg, bucket_ids=years, device=cuda_device)
    assert got.counts.shape[1] == 21
    assert_same_stats(got, run_job(toks, cfg, bucket_ids=years, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["max", "closed"])
def test_cuda_filter_stats_matches_cpu(cuda_device, mode):
    stats = cpu_stats(40_000, 4)
    assert_same_stats(extensions_filter(stats, mode, device=cuda_device),
                      extensions_filter(stats, mode, device="cpu"))


@pytest.mark.cuda
def test_cuda_document_frequencies_and_postings_match_cpu(cuda_device):
    toks = draw(20_000, 6)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB)
    for fn in (aggregations.document_frequencies, aggregations.df_suffix_lengths):
        assert_same_stats(fn(toks, cfg, device=cuda_device), fn(toks, cfg, device="cpu"))
    assert aggregations.postings(toks, cfg, device=cuda_device) == \
        aggregations.postings(toks, cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sigma_head,frac", [(16, 1 / 64), (4, 1 / 512)])
def test_cuda_sigma_split_matches_cpu(cuda_device, sigma_head, frac):
    """sigma 40 (the generic ``suffix_pack`` instance in the reference job),
    with and without the survivor buffer's retry."""
    toks = corpus.zipf_corpus(20_000, corpus.NYT, seed=7, duplicate_frac=0.3)
    cfg = NGramConfig(sigma=40, tau=TAU, vocab_size=VOCAB)
    got = suffix_sigma.sigma_split(toks, cfg, sigma_head, frac, device=cuda_device)
    assert_same_stats(got, suffix_sigma.sigma_split(toks, cfg, sigma_head, frac,
                                                    device="cpu"))
    assert got.to_dict() == run_job(toks, cfg, device=cuda_device).to_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_waves_match_cpu(cuda_device, method):
    """Each method's wave run (5 waves, the last partial) on the card equals
    the same run on the CPU, counters and all, and the monolithic job."""
    toks = draw(40_000, 3)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method,
                      apriori_index_k=2)
    wave = -(-len(toks) // 5)
    got = WaveExecutor(cfg, wave_tokens=wave, device=cuda_device).run(toks)
    assert_same_stats(got, WaveExecutor(cfg, wave_tokens=wave, device="cpu").run(toks))
    assert got.counters["waves"] == 5
    mono = run_job(toks, cfg, device=cuda_device)
    for field in ("grams", "lengths", "counts"):
        np.testing.assert_array_equal(getattr(got, field), getattr(mono, field))


@pytest.mark.cuda
@pytest.mark.parametrize("accumulator,route,overlap", [
    ("tiered", "merge", True), ("pairwise", "sort", True), ("defer", "kway", False)])
def test_cuda_wave_folds_match_cpu(cuda_device, accumulator, route, overlap):
    toks = draw(30_000, 4)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, combine_route="hash")
    kw = dict(wave_tokens=4_000, accumulator=accumulator, merge_route=route,
              overlap=overlap)
    assert_same_stats(WaveExecutor(cfg, device=cuda_device, **kw).run(toks),
                      WaveExecutor(cfg, device="cpu", **kw).run(toks))


@pytest.mark.cuda
def test_cuda_run_streaming_matches_cpu(cuda_device):
    toks = draw(30_000, 5)
    cfg = NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB)
    (gen, reports), (cgen, creports) = (
        WaveExecutor(cfg, wave_tokens=7_000, device=dev).run_streaming(toks, compress=True)
        for dev in (cuda_device, "cpu"))
    assert reports == creports
    stats = run_job(toks, cfg, device="cpu")
    g, ln = stats.grams[::7], stats.lengths[::7]
    np.testing.assert_array_equal(lookup(gen, g, ln).cpu().numpy(),
                                  lookup(cgen, g, ln).numpy())
    np.testing.assert_array_equal(lookup(gen, g, ln).cpu().numpy(), stats.counts[::7])


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_submit_wave_makes_no_host_sync(cuda_device, method):
    """A wave's whole round chain is enqueued with no host sync
    (``torch.cuda.set_sync_debug_mode("error")`` raises on any).  The first
    wave, outside the check, loads the kernels and copies the constant mask
    tables to the card once; every later wave's dispatch must not wait."""
    toks = draw(30_000, 6)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method,
                      apriori_index_k=2)
    ex = WaveExecutor(cfg, wave_tokens=8_192, device=cuda_device)
    windows = list(ex._windows(np.asarray(toks, np.int32)))
    slab, tok, n_live = windows[0]
    first = ex._collect_wave_segment(ex._submit_wave(tok, n_live, slab))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pends = [ex._submit_wave(tok, n_live, slab) for slab, tok, n_live in windows]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    parts = [ex._collect_wave_segment(p) for p in pends]
    cpu = WaveExecutor(cfg, wave_tokens=8_192, device="cpu")
    for part, (slab, tok, n_live) in zip(parts, cpu._windows(np.asarray(toks, np.int32))):
        want = cpu._collect_wave_segment(cpu._submit_wave(tok, n_live, slab))
        assert part.counters == want.counters
        assert torch.equal(part.segment.keys.cpu(), want.segment.keys)
        assert torch.equal(part.segment.counts.cpu(), want.segment.counts)
    assert torch.equal(first.segment.keys, parts[0].segment.keys)


@pytest.mark.cuda
def test_cuda_merge_path_above_two_to_the_26_rows(cuda_device):
    """Runs of 2**26 + 4,099 rows each: the Merge Path split's diagonal
    windows pass 2**26 rows, where ``split_warp`` takes 64-bit division.
    Keys in [0, 2**20) tie across the runs (A first)."""
    n = (1 << 26) + 4099
    g = torch.Generator(device=cuda_device).manual_seed(0)
    a, b = (torch.randint(0, 1 << 20, (n,), generator=g, device=cuda_device)
            .sort().values[:, None] for _ in range(2))
    av = torch.arange(n, device=cuda_device)
    bv = av + n
    got = ops.merge_path(a, b, av, bv)
    want = ref.merge_path_ref(a, b, av, bv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def http_bodies(fe_addr, requests_):
    """Each (path, body) POSTed to the server at ``fe_addr``: (status, text)."""
    import http.client
    import json
    out = []
    for path, body in requests_:
        conn = http.client.HTTPConnection(*fe_addr, timeout=60)
        conn.request("POST", path, body=json.dumps(body))
        r = conn.getresponse()
        out.append((r.status, r.read().decode()))
        conn.close()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_cuda_frontend_answers_as_cpu(cuda_device, compress):
    """A frontend over a service on the card and one over a ``device="cpu"``
    service, fed the same base and deltas (flat and compressed rungs), give
    the same HTTP bodies for lookups, top-k and SSE completions; the card's
    ``bsearch`` (and, compressed, ``block_decode``) launch during the
    queries, from the batcher's thread."""
    from repro_torch.serve import QueryFrontend, StreamingNGramService, serve_http
    toks = draw(60_000, 9)
    cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, combine_route="hash")
    base, rest = np.split(toks, [int(len(toks) * 0.6)])
    stats = run_job(toks, NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB), device="cpu")
    rng = np.random.default_rng(4)
    rows = rng.integers(0, len(stats), 300)
    reqs = [("/v1/lookup", {"grams": [stats.grams[r, :stats.lengths[r]].tolist()
                                      for r in rows[i:i + 60]] + [[VOCAB + 1], [], [1] * 9]})
            for i in range(0, 300, 60)]
    reqs += [("/v1/topk", {"prefix": stats.grams[r, :max(stats.lengths[r] - 1, 0)].tolist(),
                           "k": 8}) for r in rows[:40]]
    reqs += [("/v1/complete", {"prefix": stats.grams[r, :1].tolist(), "steps": 6, "k": 4})
             for r in rows[:6]]
    answers, launches = [], None
    for dev in (cuda_device, "cpu"):
        svc = StreamingNGramService(cfg, compress=compress, block_size=4, size_ratio=2,
                                    device=dev)
        for part in [base] + np.array_split(rest, 3):
            svc.ingest(part)
        with QueryFrontend(svc, deadline_s=0.002) as fe:
            srv = serve_http(fe, "127.0.0.1", 0, block=False)
            try:
                ops.launches.clear()
                answers.append(http_bodies(srv.server_address, reqs))
                if launches is None:
                    launches = dict(ops.launches)
            finally:
                srv.shutdown()
                srv.server_close()
    assert answers[0] == answers[1]
    assert all(status == 200 for status, _ in answers[0])
    assert launches.get("bsearch", 0) > 0
    if compress:
        assert launches.get("block_decode", 0) > 0



def _ranks_on_the_card(mesh, toks, stats, g, ln):
    """The four methods and the sharded index, flat and compressed, on one
    rank of ``mesh`` (runs in each spawned rank)."""
    from repro_torch.index import build_sharded_index, serve_queries
    from repro_torch.kernels import ops as kops
    from repro_torch.pipeline import stages
    kops.launches.clear()
    out = {}
    for method in sorted(METHODS):
        cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method)
        st = stages.canonical_stats(run_job(toks, cfg, mesh))
        out[method] = (st.grams, st.lengths, st.counts, st.counters["map_records"])
    for compress in (False, True):
        sh = build_sharded_index(stats, vocab_size=VOCAB, mesh=mesh, compress=compress)
        out[f"lookup-{compress}"] = serve_queries(sh, g, ln)
        out[f"cont-{compress}"] = serve_queries(sh, g, np.maximum(ln - 1, 0),
                                                mode="continuations", k=8)
    out["launches"] = dict(kops.launches)
    out["device"] = str(mesh.device)
    return out


def _nccl_rank(mesh, stats, g, ln):
    """The flat sharded index's answers and an object gather on one NCCL
    rank (runs in the spawned rank)."""
    from repro_torch.index import build_sharded_index, serve_queries
    sh = build_sharded_index(stats, vocab_size=VOCAB, mesh=mesh)
    return dict(backend=mesh.backend, lookup=serve_queries(sh, g, ln),
                cont=serve_queries(sh, g, np.maximum(ln - 1, 0), mode="continuations",
                                   k=8),
                objects=mesh.all_gather_object({"rank": mesh.rank, "rows": g[:3]}),
                comm_seconds=mesh.comm_seconds)


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_match_cpu(cuda_device):
    """Two gloo ranks sharing the card: each method's output equals the
    single-device job on the CPU, and the sharded index's answers equal the
    CPU index's; the ranks launch the kernels."""
    from repro_torch.index import build_index, continuations, lookup
    from repro_torch.launch.mesh import spawn_ranks
    toks = draw(40_000, 3)
    stats = cpu_stats(40_000, 3)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, len(stats), 2000)
    g, ln = stats.grams[rows].copy(), stats.lengths[rows].copy()
    g[::3, 0] = VOCAB                                     # misses among the hits
    ranks = spawn_ranks(2, _ranks_on_the_card, toks, stats, g, ln, device=cuda_device,
                        backend="gloo")
    idx = build_index(stats, vocab_size=VOCAB, device="cpu")
    want_cont = continuations(idx, g, np.maximum(ln - 1, 0), k=8)
    want_cont = torch.cat([want_cont[0][:, None], want_cont[1][:, None],
                           want_cont[2], want_cont[3]], dim=1).numpy()
    for r in ranks:
        assert r["device"].startswith("cuda")
        for method in sorted(METHODS):
            one = run_job(toks, NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB,
                                            method=method), device="cpu")
            for got, want in zip(r[method], (one.grams, one.lengths, one.counts,
                                             one.counters["map_records"])):
                np.testing.assert_array_equal(got, want)
        for compress in (False, True):
            np.testing.assert_array_equal(r[f"lookup-{compress}"],
                                          lookup(idx, g, ln).numpy())
            np.testing.assert_array_equal(r[f"cont-{compress}"], want_cont)
        for kernel in ("suffix_pack", "hash_partition", "lcp_boundary", "bsearch",
                       "block_decode"):
            assert r["launches"].get(kernel, 0) > 0, kernel


@pytest.mark.cuda
def test_cuda_one_nccl_rank_matches_cpu(cuda_device):
    """One NCCL rank on the card: the flat sharded index answers as the CPU
    index does, objects gather through device tensors, and the collectives'
    seconds come from CUDA events."""
    from repro_torch.index import build_index, continuations, lookup
    from repro_torch.launch.mesh import spawn_ranks
    stats = cpu_stats(40_000, 3)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, len(stats), 2000)
    g, ln = stats.grams[rows].copy(), stats.lengths[rows].copy()
    g[::3, 0] = VOCAB
    ln[::7] = 1                                           # length-0 prefixes below
    (r,) = spawn_ranks(1, _nccl_rank, stats, g, ln, device=cuda_device, backend="nccl")
    idx = build_index(stats, vocab_size=VOCAB, device="cpu")
    nd, tot, terms, counts = continuations(idx, g, np.maximum(ln - 1, 0), k=8)
    assert r["backend"] == "nccl"
    np.testing.assert_array_equal(r["lookup"], lookup(idx, g, ln).numpy())
    np.testing.assert_array_equal(
        r["cont"], torch.cat([nd[:, None], tot[:, None], terms, counts], 1).numpy())
    assert len(r["objects"]) == 1 and r["objects"][0]["rank"] == 0
    np.testing.assert_array_equal(r["objects"][0]["rows"], g[:3])
    assert r["comm_seconds"] > 0


def _mesh_waves_on_ranks(mesh, toks, g, ln):
    """The mesh waves (SUFFIX-sigma on the hash combiner and APRIORI-SCAN
    under the tiered fold with the fold thread, NAIVE deferred without it), ``run_streaming`` and
    ``shard_generational`` with a re-shard, on one rank of ``mesh`` (runs in
    each spawned rank)."""
    from repro_torch.index import continuations, serve_queries, shard_generational
    from repro_torch.kernels import ops as kops
    kops.launches.clear()
    out = {}
    for method, acc, overlap in (("suffix_sigma", "tiered", True),
                                 ("apriori_scan", "tiered", True),
                                 ("naive", "defer", False)):
        cfg = NGramConfig(sigma=SIGMA, tau=TAU, vocab_size=VOCAB, method=method,
                          combine_route="hash" if method == "suffix_sigma" else "sort")
        st = WaveExecutor(cfg, wave_tokens=7_000, mesh=mesh, accumulator=acc,
                          overlap=overlap, device=mesh.device).run(toks)
        out[method] = (st.grams, st.lengths, st.counts, dict(st.counters))
    cfg1 = NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB)
    gen, reports = WaveExecutor(cfg1, wave_tokens=10_000, mesh=mesh,
                                device=mesh.device).run_streaming(
                                    toks, compress=True, size_ratio=2)
    out["reports"] = [{k: r[k] for k in ("ingested_rows", "merges", "segment_rows")}
                      for r in reports]
    sh = shard_generational(gen, mesh=mesh)
    pl = np.maximum(ln - 1, 0)
    out["lookup"] = serve_queries(sh, g, ln)
    out["cont"] = serve_queries(sh, g, pl, mode="continuations", k=8)
    nd, tot, terms, counts = continuations(gen, g, pl, k=8)
    out["gen_cont"] = torch.cat([nd[:, None], tot[:, None], terms, counts], 1).cpu().numpy()
    out["merges"] = gen.ingest(run_job(toks, cfg1, device=mesh.device))["merges"]
    out["reshard"] = serve_queries(shard_generational(gen, mesh=mesh, prev=sh), g, ln)
    out["launches"] = dict(kops.launches)
    return out


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_stream_as_on_the_cpu(cuda_device):
    """Two gloo ranks sharing the card: the mesh waves' stats and counters,
    the streaming ingest's reports and the sharded generational index's
    answers equal two gloo ranks on the CPU; the ranks on the card launch
    all eight kernels."""
    from repro_torch.launch.mesh import spawn_ranks
    toks = draw(30_000, 4)
    rows = np.random.default_rng(2).integers(0, 20_000, 2000)
    stats = cpu_stats(30_000, 4)
    rows %= len(stats)
    g, ln = stats.grams[rows].copy(), stats.lengths[rows].copy()
    g[::3, 0] = VOCAB                                     # misses among the hits
    card = spawn_ranks(2, _mesh_waves_on_ranks, toks, g, ln, device=cuda_device,
                       backend="gloo")
    host = spawn_ranks(2, _mesh_waves_on_ranks, toks, g, ln, device="cpu")
    for r in card + host:
        for key in ("suffix_sigma", "apriori_scan", "naive"):
            got, want = r[key], host[0][key]
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3], key
        assert r["reports"] == host[0]["reports"]
        assert r["merges"] == host[0]["merges"] >= 1      # a compressed rung merges
        for key in ("lookup", "cont", "gen_cont", "reshard"):
            np.testing.assert_array_equal(r[key], host[0][key])
    np.testing.assert_array_equal(host[0]["cont"], host[0]["gen_cont"])
    for kernel in ("suffix_pack", "hash_partition", "lcp_boundary", "hash_combine",
                   "merge_path", "block_expand", "bsearch", "block_decode"):
        assert any(r["launches"].get(kernel, 0) > 0 for r in card), kernel


@pytest.mark.cuda
def test_cuda_reduced_lm_serving_matches_cpu(cuda_device):
    """Each LM arch's REDUCED config (float32) with the same seeded weights on
    the card and on the CPU: prefill 2x12, then 6 decode steps of fixed
    tokens (mixtral's window of 8 wraps its ring), every logit within 1e-4
    (rtol and atol) of the CPU's.  TF32 is off, so the card's float32
    matmuls are float32 and differ from the CPU's only in the order of
    their sums."""
    import copy

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    def run(model, toks):
        with torch.inference_mode():
            cache, logits = tf.prefill(model, toks[:, :12], max_seq=18)
            out = [logits]
            for i in range(12, 18):
                logits, cache = tf.decode_step(model, cache, toks[:, i], i)
                out.append(logits)
        return [o.cpu() for o in out]

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in LM_ARCHS:
            cfg = configs.get(arch).make_reduced()
            cpu = tf.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu).to(cuda_device)
            toks = torch.as_tensor(np.random.default_rng(3).integers(1, cfg.vocab_size,
                                                                     (2, 18)))
            for got, want in zip(run(card, toks.to(cuda_device)), run(cpu, toks)):
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_cuda_reduced_lm_train_step_matches_cpu(cuda_device):
    """Each LM arch's REDUCED config (float32) with the same seeded weights on
    the card and on the CPU: one ``make_train_step`` on a 4x16 batch.  The
    loss, the gradient norm and every gradient and first-moment leaf within
    1e-4 of the CPU's (max abs error over the leaf's max abs: the sums run
    in another order); every updated parameter within 1e-6 of its leaf's
    max abs, but for the few entries (under 1e-3 of a leaf) whose gradient
    is so near 0 that a rounding flips its sign in Adam's ``m / sqrt(v)``,
    which moves them by up to 2 lr.  TF32 is off."""
    import copy

    from repro_torch import configs
    from repro_torch.data.loader import SyntheticLMLoader
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer, train_loop
    from repro_torch.training.tree import Stacked, named_leaves

    def leaves(tree):
        return {n: (torch.stack(tuple(v)) if isinstance(v, Stacked) else v)
                .detach().double().cpu() for n, v in named_leaves(tree)}

    def one_step(model, batch):
        b = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
        params = tf.param_tree(model)
        loss, _, grads = train_loop.value_and_grad(
            lambda p, x: tf.loss_fn(model, x), params, b)
        step = train_loop.make_train_step(lambda p, x: tf.loss_fn(model, x),
                                          optimizer.OptimizerConfig(
                                              peak_lr=1e-3, warmup_steps=2, decay_steps=50))
        params, state, m = step(params, optimizer.init_state(params), b)
        return (float(loss), float(m["grad_norm"]), float(m["lr"]), leaves(grads),
                leaves(state["m"]), leaves(params))

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in LM_ARCHS:
            cfg = configs.get(arch).make_reduced()
            cpu = tf.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu).to(cuda_device)
            batch = SyntheticLMLoader(cfg.vocab_size, 16, 4).batch_at(0)
            want = one_step(cpu.requires_grad_(True), batch)
            got = one_step(card.requires_grad_(True), batch)
            for g, w in zip(got[:2], want[:2]):
                assert abs(g - w) <= 1e-4 * abs(w), arch
            lr = want[2]
            for g_tree, w_tree in zip(got[3:5], want[3:5]):
                for n, w in w_tree.items():
                    err = (g_tree[n] - w).abs().max() / max(float(w.abs().max()), 1e-30)
                    assert err <= 1e-4, (arch, n, float(err))
            for n, w in want[5].items():
                d = (got[5][n] - w).abs()
                tight = 1e-6 * float(w.abs().max())
                assert float(d.max()) <= tight + 2 * lr, (arch, n)
                assert int((d > tight + 1e-6 * lr).sum()) < 1e-3 * d.numel(), (arch, n)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_cuda_reduced_recsys_and_gnn_train_step_matches_cpu(cuda_device):
    """Each recsys arch's and gin-tu's REDUCED config (float32; GIN also
    with bf16 node features on the wire) with the same seeded weights on the
    card and on the CPU: one ``make_train_step`` on a seeded batch.  The
    loss and every gradient and first-moment leaf within 1e-4 of the CPU's
    (max abs error over the leaf's max abs: the sums run in another order,
    an ``index_add_`` on the card in no fixed order).  TF32 is off."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.data import graph, recsys as rdata
    from repro_torch.models import gnn, recsys
    from repro_torch.training import optimizer, train_loop
    from repro_torch.training.tree import named_leaves

    def batch_of(arch, cfg):
        if arch == "gin-tu":
            g = graph.random_graph(300, 2000, cfg.d_feat, cfg.n_classes, seed=1)
            return {"features": g.features, "edge_src": g.edge_index[0],
                    "edge_dst": g.edge_index[1], "labels": g.labels,
                    "edge_mask": np.arange(2000) % 5 != 0,
                    "label_mask": np.arange(300) % 2 == 0}
        gen = {"bst": lambda: rdata.BehaviorSeqGen(cfg.item_vocab, cfg.seq_len),
               "two-tower-retrieval": lambda: rdata.RetrievalGen(cfg.item_vocab,
                                                                 cfg.user_feat)}.get(
            arch, lambda: rdata.CTRBatchGen((cfg.field_vocab,) * cfg.n_sparse))()
        return gen.batch_at(0, 64)

    def one_step(model, mod, cfg, batch):
        b = {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()}
        params = mod.param_tree(model)
        step = train_loop.make_train_step(lambda p, x: mod.loss_fn(p, x, cfg),
                                          optimizer.OptimizerConfig(
                                              peak_lr=1e-3, warmup_steps=2, decay_steps=50))
        _, state, m = step(params, optimizer.init_state(params), b)
        return float(m["loss"]), {n: v.detach().double().cpu()
                                  for n, v in named_leaves(state["m"])}

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = [(a, configs.get(a).make_reduced()) for a in configs.all_archs()
                 if configs.get(a).family == "recsys"]
        gin = configs.get("gin-tu").make_reduced()
        cases += [("gin-tu", gin), ("gin-tu", dataclasses.replace(
            gin, comm_dtype=torch.bfloat16))]
        for arch, cfg in cases:
            mod = gnn if arch == "gin-tu" else recsys
            cpu = mod.init_params(cfg, "cpu", torch.Generator().manual_seed(0))
            card = copy.deepcopy(cpu).to(cuda_device)
            batch = batch_of(arch, cfg)
            want = one_step(cpu.requires_grad_(True), mod, cfg, batch)
            got = one_step(card.requires_grad_(True), mod, cfg, batch)
            assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0]), arch
            for n, w in want[1].items():
                err = (got[1][n] - w).abs().max() / max(float(w.abs().max()), 1e-30)
                assert err <= 1e-4, (arch, n, float(err))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
