"""The port's multi-rank batch path against ``repro``'s ``shard_map`` path.

The same seeded inputs go through ``repro`` on a host mesh of 8 and of 3
devices (subprocesses, as ``tests/test_distributed.py`` runs them) and
through the port on 8 and 3 gloo ranks on the CPU (``spawn_ranks`` with
``device="cpu"``).  Everything is compared exactly, every case at the same
number of parts (the shuffle counters depend on it):

  * the four methods on ``test_distributed.py``'s 900-token corpus and on a
    20k-token NYT-profile corpus at sigma 4, tau 2 (stats and counters);
  * the shuffle overflow retry (vocab 2, ``capacity_factor=0.05``, no
    combiner), SUFFIX-sigma with time-series bucket ids, and with the hash
    combiner;
  * the sharded index, flat and compressed: every gram, a miss-heavy batch,
    top-8 continuations with length-0 prefixes among them, and
    ``describe_topology`` (whose ``nbytes``, the resident bytes, counts the
    port's int64 lanes and caches; the compressed bytes at rest are equal);
  * every rank given only its own shard (the rest of the corpus junk) gives
    the same output, so a rank reads its neighbour's tokens only through
    the halo exchange;
  * APRIORI-INDEX with its posting-list join (sigma 5, K = 2) equals the
    oracle and the single-device job.  ``repro``'s mesh job is not held to
    this case: its records carry shard-local positions, and its joined
    rounds lose occurrences (``ROADMAP.md`` Queue 3).

``bucketize`` and ``shard_of_rows`` are also held against ``repro``'s in
this process.  The ranks' functions live here, so this module imports no
JAX at its top: each rank imports it to find them.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import NGramConfig, oracle, run_job
from repro_torch.core.stats import NGramStats
from repro_torch.data import corpus
from repro_torch.index import build_sharded_index, serve_queries
from repro_torch.index.serve import describe_topology, shard_of_rows
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.mapreduce import shuffle
from repro_torch.serve.service import make_query_stream

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads would only take their cores.
torch.set_num_threads(1)

VOCAB = corpus.NYT.vocab_size
METHODS = ("suffix_sigma", "naive", "apriori_scan", "apriori_index")
PARTS = (8, 3)
TOP_K = 8

#: name -> (corpus, NGramConfig keywords, bucket ids or None)
JOBS = {
    **{f"{m}-rand": ("rand", dict(sigma=4, tau=2, vocab_size=59, method=m), None)
       for m in METHODS},
    **{f"{m}-nyt": ("nyt", dict(sigma=4, tau=2, vocab_size=VOCAB, method=m), None)
       for m in METHODS},
    "overflow": ("tiny", dict(sigma=3, tau=1, vocab_size=2, capacity_factor=0.05,
                              combine=False), None),
    "series": ("nyt", dict(sigma=3, tau=2, vocab_size=VOCAB, n_buckets=21), "years"),
    "hash": ("nyt", dict(sigma=4, tau=2, vocab_size=VOCAB, combine_route="hash"), None),
}
LAYOUTS = ("flat", "compressed")
QUERIES = ("all", "miss", "cont")
#: the join case of APRIORI-INDEX (port only; see the module docstring)
JOIN_CFG = dict(sigma=5, tau=2, vocab_size=59, method="apriori_index",
                apriori_index_k=2)

REPRO_CODE = """
import json, numpy as np, jax
from repro.core import run_job
from repro.core.stats import NGramConfig, NGramStats
from repro.index import build_sharded_index, serve_queries
from repro.index.serve import describe_topology
mesh = jax.make_mesh(({n},), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
inp = dict(np.load({inputs!r}))
jobs = json.loads({jobs!r})
out, meta = {{}}, {{"counters": {{}}, "topology": {{}}}}
for name, (tk, kw, bk) in jobs.items():
    extra = {{"bucket_ids": inp[bk]}} if bk else {{}}
    st = run_job(inp[tk], NGramConfig(**kw), mesh=mesh, **extra)
    out[name + "/grams"], out[name + "/lengths"], out[name + "/counts"] = (
        st.grams, st.lengths, st.counts)
    meta["counters"][name] = {{k: float(v) for k, v in st.counters.items()}}
stats = NGramStats(inp["idx_grams"], inp["idx_lengths"], inp["idx_counts"])
for layout in ("flat", "compressed"):
    sh = build_sharded_index(stats, vocab_size={vocab}, mesh=mesh,
                             compress=layout == "compressed")
    out[layout + "/all"] = serve_queries(sh, inp["all_g"], inp["all_l"])
    out[layout + "/miss"] = serve_queries(sh, inp["miss_g"], inp["miss_l"])
    out[layout + "/cont"] = serve_queries(sh, inp["cont_g"], inp["cont_l"],
                                          mode="continuations", k={k})
    meta["topology"][layout] = describe_topology(sh)
    meta["topology"][layout]["at_rest"] = int(getattr(sh.index, "nbytes_at_rest", 0))
np.savez({out!r}, **out)
json.dump(meta, open({meta!r}, "w"))
print("OK")
"""


def _inputs() -> dict:
    """Every case's input, made from seeds."""
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 60, 900)                   # test_distributed's corpus
    nyt, years = corpus.zipf_corpus(20_000, corpus.NYT, seed=5, duplicate_frac=0.05,
                                    with_years=True)
    tiny = np.random.default_rng(1).integers(0, 3, 4000)
    stats = run_job(nyt, NGramConfig(sigma=4, tau=2, vocab_size=VOCAB), device="cpu")
    all_l = stats.lengths.astype(np.int32)
    miss_g, miss_l = make_query_stream(stats, n_queries=3000, sigma=4,
                                       vocab_size=VOCAB, miss_frac=0.7, seed=1)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, len(stats), 500)
    cont_l = np.minimum(stats.lengths[rows], rng.integers(0, 4, 500)).astype(np.int32)
    cont_l[:64] = 0                                   # top-k unigrams among them
    cont_g = (stats.grams[rows] * (np.arange(4)[None, :] < cont_l[:, None])
              ).astype(np.int32)
    return dict(rand=rand, nyt=nyt, years=years, tiny=tiny,
                idx_grams=stats.grams, idx_lengths=stats.lengths,
                idx_counts=stats.counts, all_g=stats.grams, all_l=all_l,
                miss_g=miss_g, miss_l=miss_l, cont_g=cont_g, cont_l=cont_l)


def _stats_out(st: NGramStats) -> tuple:
    return st.grams, st.lengths, st.counts, dict(st.counters)


def _own_rows_only(tokens: np.ndarray, mesh) -> np.ndarray:
    """``tokens`` with every row but this rank's replaced by junk."""
    n_local = -(-len(tokens) // mesh.size)
    junk = np.random.default_rng(100 + mesh.rank).integers(1, 59, len(tokens))
    lo = mesh.rank * n_local
    junk[lo:lo + n_local] = tokens[lo:lo + n_local]
    return junk


def _port_cases(mesh, inp: dict) -> dict:
    """Every case on this rank (runs in each spawned rank)."""
    out = {"jobs": {}, "index": {}, "topology": {}, "own_rows": {}}
    for name, (tk, kw, bk) in JOBS.items():
        extra = {"bucket_ids": inp[bk]} if bk else {}
        out["jobs"][name] = _stats_out(run_job(inp[tk], NGramConfig(**kw), mesh,
                                               device="cpu", **extra))
    stats = NGramStats(inp["idx_grams"], inp["idx_lengths"], inp["idx_counts"])
    for layout in LAYOUTS:
        sh = build_sharded_index(stats, vocab_size=VOCAB, mesh=mesh,
                                 compress=layout == "compressed", device="cpu")
        out["index"][layout + "/all"] = serve_queries(sh, inp["all_g"], inp["all_l"])
        out["index"][layout + "/miss"] = serve_queries(sh, inp["miss_g"], inp["miss_l"])
        out["index"][layout + "/cont"] = serve_queries(
            sh, inp["cont_g"], inp["cont_l"], mode="continuations", k=TOP_K)
        out["topology"][layout] = describe_topology(sh)
        (out["topology"][layout]["at_rest"],) = mesh.sum_ints(
            getattr(sh.index, "nbytes_at_rest", 0))
    for m in METHODS:
        out["own_rows"][m] = _stats_out(run_job(
            _own_rows_only(inp["rand"], mesh),
            NGramConfig(sigma=4, tau=2, vocab_size=59, method=m), mesh, device="cpu"))
    out["join"] = _stats_out(run_job(inp["rand"], NGramConfig(**JOIN_CFG), mesh,
                                     device="cpu"))
    out["join_own_rows"] = _stats_out(run_job(_own_rows_only(inp["rand"], mesh),
                                              NGramConfig(**JOIN_CFG), mesh,
                                              device="cpu"))
    out["comm"] = (mesh.comm_bytes, mesh.comm_seconds)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{P: (repro arrays, repro meta, the port's results of every rank)}."""
    pytest.importorskip("jax")
    from test_distributed import run_with_devices
    tmp = tmp_path_factory.mktemp("distributed")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    jobs = json.dumps(JOBS)

    def repro(n):
        code = REPRO_CODE.format(n=n, inputs=str(tmp / "inputs.npz"), jobs=jobs,
                                 vocab=VOCAB, k=TOP_K, out=str(tmp / f"repro{n}.npz"),
                                 meta=str(tmp / f"repro{n}.json"))
        errors[n] = None
        try:
            run_with_devices(code, n)
        except BaseException as e:              # re-raised below, on the test's thread
            errors[n] = e

    errors: dict = {}
    threads = [threading.Thread(target=repro, args=(n,)) for n in PARTS]
    for t in threads:
        t.start()
    port = {n: spawn_ranks(n, _port_cases, inp, device="cpu") for n in PARTS}
    for t in threads:
        t.join()
    out = {}
    for n in PARTS:
        if errors[n] is not None:
            raise errors[n]
        out[n] = (dict(np.load(tmp / f"repro{n}.npz")),
                  json.load(open(tmp / f"repro{n}.json")), port[n], inp)
    return out


def _same_on_every_rank(ranks: list, get) -> object:
    first = get(ranks[0])
    for r in ranks[1:]:
        other = get(r)
        assert len(first) == len(other)
        for a, b in zip(first, other):
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b)
            else:
                assert a == b
    return first


@pytest.mark.parametrize("n", PARTS)
@pytest.mark.parametrize("name", list(JOBS))
def test_jobs_equal_repro_mesh(runs, n, name):
    want, meta, ranks, _ = runs[n]
    grams, lengths, counts, counters = _same_on_every_rank(
        ranks, lambda r: r["jobs"][name])
    assert np.array_equal(grams, want[name + "/grams"])
    assert np.array_equal(lengths, want[name + "/lengths"])
    assert np.array_equal(counts, want[name + "/counts"])
    assert counters == meta["counters"][name]
    assert len(lengths) > 0
    if name == "overflow":
        assert counters["retries"] >= 1 and counters["overflow"] == 0


@pytest.mark.parametrize("n", PARTS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("query", QUERIES)
def test_sharded_index_equal_repro_serve_queries(runs, n, layout, query):
    want, _, ranks, inp = runs[n]
    got = ranks[0]["index"][f"{layout}/{query}"]
    for r in ranks[1:]:
        assert np.array_equal(r["index"][f"{layout}/{query}"], got)
    assert np.array_equal(got, want[f"{layout}/{query}"])
    if query == "miss":
        assert 0 < (got > 0).mean() < 0.5
    if query == "cont":
        assert (got[inp["cont_l"] == 0] == got[0]).all() and got[0, 0] > TOP_K


@pytest.mark.parametrize("n", PARTS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_describe_topology_equal_repro_but_resident_bytes(runs, n, layout):
    """Equal to ``repro``'s but ``nbytes``, the resident bytes, which count
    the port's int64 lanes and query caches; the compressed shards' bytes at
    rest add up to ``repro``'s stacked shards' (one shape for every shard)."""
    _, meta, ranks, _ = runs[n]
    got = dict(_same_on_every_rank(ranks, lambda r: [r["topology"][layout]])[0])
    want = dict(meta["topology"][layout])
    assert got["kind"] == "sharded" and got["n_parts"] == n
    assert got.pop("nbytes") > want.pop("nbytes") > 0
    if layout == "compressed":
        assert got["at_rest"] > 0
    assert got == want


@pytest.mark.parametrize("n", PARTS)
def test_each_rank_reads_only_its_own_rows(runs, n):
    ranks = runs[n][2]
    for r in ranks:
        for m in METHODS:
            for a, b in zip(r["own_rows"][m], r["jobs"][f"{m}-rand"]):
                assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, m
        for a, b in zip(r["join_own_rows"], r["join"]):
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b


@pytest.mark.parametrize("n", PARTS)
def test_apriori_index_join_equals_oracle_and_one_device(runs, n):
    inp, ranks = runs[n][3], runs[n][2]
    grams, lengths, counts, counters = _same_on_every_rank(ranks, lambda r: r["join"])
    st = NGramStats(grams, lengths, counts)
    assert st.to_dict() == oracle.ngram_counts(inp["rand"], 5, 2)
    one = run_job(inp["rand"], NGramConfig(**JOIN_CFG), device="cpu")
    for key in ("jobs", "map_records", "shuffle_records", "shuffle_bytes"):
        assert counters[key] == one.counters[key], key
    assert all(r["comm"][0] > 0 for r in ranks)


def test_bucketize_equals_repro():
    """Random parts with the drop bucket and overflowing parts."""
    pytest.importorskip("jax")
    from repro.mapreduce import shuffle as jshuffle
    rng = np.random.default_rng(3)
    for n, n_parts, capacity in ((1, 1, 8), (257, 4, 40), (1000, 3, 200), (64, 8, 8)):
        records = rng.integers(0, 2**32, (n, 5), dtype=np.uint64).astype(np.uint32)
        part = rng.integers(0, n_parts + 1, n).astype(np.int32)
        jbuf, jover = jshuffle.bucketize(records, part, n_parts, capacity)
        buf, over = shuffle.bucketize(torch.as_tensor(records.astype(np.int64)),
                                      torch.as_tensor(part), n_parts, capacity)
        assert np.array_equal(buf.numpy(), np.asarray(jbuf).astype(np.int64))
        assert int(over) == int(jover)


def test_shard_of_rows_equals_repro():
    pytest.importorskip("jax")
    from repro.index.serve import shard_of_rows as jshard_of_rows
    terms = np.random.default_rng(4).integers(1, 2**31, 5000)
    for n_parts in (1, 3, 8):
        assert np.array_equal(shard_of_rows(terms, n_parts),
                              jshard_of_rows(terms, n_parts))
