"""The port's serving tier (``repro_torch.serve``) against ``repro.serve`` on CPU.

The batcher, admission and stub-frontend cases of ``tests/test_frontend.py``
run on both packages (ids ``port`` / ``repro``), driven by the same
deterministic stubs: recording executors, manual flush mode, injected
clocks.  Then the whole stack end to end: a ``repro`` server and a port
server (``device="cpu"``) over the same 1,500 tokens, where every
``/v1/lookup``, ``/v1/topk``, ``/v1/complete`` and error-path body must be
equal, and ``/v1/system/topology`` too apart from ``devices`` and the flat
layout's ``nbytes`` (the port's lanes are int64).  Exact throughout.
"""
from __future__ import annotations

import http.client
import json
import threading
import time
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")      # a GPU host without JAX skips this file

import repro.obs.metrics as jmetrics
import repro.obs.trace as jtrace
import repro.serve.admission as jadmission
import repro.serve.batcher as jbatcher
import repro.serve.frontend as jfrontend
import repro.serve.http as jhttp
import repro.serve.service as jservice
import repro_torch.obs.metrics as metrics
import repro_torch.obs.trace as trace
import repro_torch.serve.admission as admission
import repro_torch.serve.batcher as batcher
import repro_torch.serve.frontend as frontend
import repro_torch.serve.http as http_mod
import repro_torch.serve.service as service

# The tensors here are small, and a parallel test run shares the host's cores
# between its workers: intra-op threads (which spin between parallel regions)
# would only take cores from the other workers' tests.
torch.set_num_threads(1)

SIGMA, VOCAB = 3, 30

PACKAGES = {
    "port": SimpleNamespace(admission=admission, batcher=batcher, frontend=frontend,
                            http=http_mod, service=service, metrics=metrics,
                            trace=trace),
    "repro": SimpleNamespace(admission=jadmission, batcher=jbatcher, frontend=jfrontend,
                             http=jhttp, service=jservice, metrics=jmetrics,
                             trace=jtrace),
}


@pytest.fixture(params=["port", "repro"])
def pkg(request):
    """One package's serving modules, with its registry reset around the test."""
    p = PACKAGES[request.param]
    p.metrics.set_registry(None)
    yield p
    p.metrics.set_registry(None)
    p.trace.disable_tracing()


@pytest.fixture
def reg(pkg):
    r = pkg.metrics.MetricsRegistry()
    pkg.metrics.set_registry(r)
    return r


class RecordingExecutor:
    """Answers lookups as f(gram) so tests can check per-slot routing."""

    def __init__(self):
        self.batches = []          # (kind, k, grams, lengths) per flush
        self.collected = 0

    def submit(self, kind, k, grams, lengths):
        self.batches.append((kind, k, grams.copy(), lengths.copy()))
        return kind, k, grams.copy(), lengths.copy()

    def collect(self, rec):
        kind, k, g, ln = rec
        self.collected += 1
        if kind == "lookup":
            return g[:, 0].astype(np.int64) * 100 + ln.astype(np.int64)
        rows = np.zeros((g.shape[0], 2 + 2 * k), np.int64)
        rows[:, 0] = g[:, 0]
        return rows


def req(pkg, term: int, *, length: int = 1, kind: str = "lookup", k: int = 8,
        priority: int = 0):
    gram = np.zeros((SIGMA,), np.int32)
    gram[0] = term
    return pkg.batcher.Request(kind, gram, length, k=k, priority=priority)


def stub_service(pkg, generation: int = 1):
    """The minimal service surface QueryFrontend needs (key fns + config)."""
    svc = pkg.service.StreamingNGramService
    return SimpleNamespace(
        cfg=SimpleNamespace(sigma=SIGMA, vocab_size=VOCAB),
        gen=SimpleNamespace(generation=generation),
        lookup_key=svc.lookup_key, continuation_key=svc.continuation_key)


def make_frontend(pkg, **admission_kw):
    return pkg.frontend.QueryFrontend(
        stub_service(pkg), executor=RecordingExecutor(),
        admission=pkg.admission.AdmissionController(**admission_kw),
        deadline_s=10.0, autostart=False)


# ------------------------------------------------------------ bucket policy

def test_select_bucket_deterministic(pkg):
    sb = pkg.batcher.select_bucket
    buckets = (16, 64, 256)
    assert [sb(n, buckets) for n in (1, 16, 17, 65, 10_000)] == [16, 16, 64, 256, 256]
    with pytest.raises(ValueError):
        sb(0, buckets)
    assert pkg.batcher.DEFAULT_BUCKETS == (16, 64, 256)
    assert pkg.batcher.FILL_BOUNDARIES == jbatcher.FILL_BOUNDARIES


def test_flush_pads_to_bucket_and_zero_fills(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(4, 8), deadline_s=10.0,
                                      autostart=False)
    reqs = [req(pkg, t + 1) for t in range(3)]
    for r in reqs:
        b.enqueue(r)
    batch = b.flush_once(force=True)
    b.collect_inflight()
    assert [r.seq for r in batch] == [0, 1, 2]
    kind, _, g, ln = ex.batches[0]
    assert kind == "lookup" and g.shape == (4, SIGMA)    # 3 live -> bucket 4
    np.testing.assert_array_equal(g[:3, 0], [1, 2, 3])
    np.testing.assert_array_equal(g[3], 0)               # pad slot is zeros
    assert ln[3] == 0
    assert [r.future.result(0) for r in reqs] == [101, 201, 301]
    assert b.stats()["padded_slots"] == 1


def test_full_bucket_caps_flush_size(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(2, 4), deadline_s=10.0,
                                      autostart=False)
    for t in range(6):
        b.enqueue(req(pkg, t + 1))
    assert b.flush_once() is not None      # 6 queued >= cap 4: due immediately
    assert ex.batches[0][2].shape[0] == 4
    assert b.depth == 2
    assert b.flush_once() is None          # 2 < cap, deadline far: not due


def test_deadline_flush_without_busy_wait(pkg):
    """A partial bucket flushes at the deadline off a condition-variable
    wait: the loop wakes O(1) times, no poll loop spins."""
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(4, 8), deadline_s=0.05)
    try:
        t0 = time.perf_counter()
        reqs = [req(pkg, t + 1) for t in range(3)]
        for r in reqs:
            b.enqueue(r)
        vals = [r.future.result(timeout=5.0) for r in reqs]
        elapsed = time.perf_counter() - t0
        assert vals == [101, 201, 301]
        assert 0.02 <= elapsed <= 2.0        # flushed by deadline, not instantly
        st = b.stats()
        assert st["batches"] == 1 and st["requests"] == 3
        assert st["wait_cycles"] <= 10
    finally:
        b.stop()


def test_stop_drains_everything(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(4,), deadline_s=60.0)
    reqs = [req(pkg, t + 1) for t in range(3)]
    for r in reqs:
        b.enqueue(r)
    b.stop()                                 # deadline far away: stop flushes
    assert all(r.future.done() for r in reqs)
    with pytest.raises(RuntimeError):
        b.enqueue(req(pkg, 9))


def test_batches_are_submitted_and_collected_on_the_flush_thread(pkg):
    """Every submit and collect of a running batcher happens on its one flush
    thread (the port launches and reads back a batch's device work there)."""
    seen = []

    class ThreadRecorder(RecordingExecutor):
        def submit(self, *a):
            seen.append(threading.get_ident())
            return super().submit(*a)

        def collect(self, rec):
            seen.append(threading.get_ident())
            return super().collect(rec)

    b = pkg.batcher.ContinuousBatcher(ThreadRecorder(), buckets=(2,), deadline_s=0.001)
    reqs = [req(pkg, t + 1) for t in range(9)]
    for r in reqs:
        b.enqueue(r)
    assert [r.future.result(timeout=5.0) for r in reqs] == [100 * (t + 1) + 1
                                                            for t in range(9)]
    b.stop()
    assert len(seen) == 10 and len(set(seen)) == 1
    assert seen[0] != threading.get_ident()


# ------------------------------------------------------------ priority order

def test_priority_ordering_under_contention(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(8,), deadline_s=10.0,
                                      autostart=False)
    low = [req(pkg, t + 1, priority=1) for t in range(3)]
    for r in low:
        b.enqueue(r)
    high = req(pkg, 7, priority=0)
    b.enqueue(high)                          # arrives last, flushes first
    first = b.flush_once(force=True)
    second = b.flush_once(force=True)
    b.collect_inflight()
    assert first == [high]
    assert second == low
    assert ex.batches[0][2][0, 0] == 7
    np.testing.assert_array_equal(ex.batches[1][2][:3, 0], [1, 2, 3])


def test_lanes_split_by_kind_and_k(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(8,), deadline_s=10.0,
                                      autostart=False)
    b.enqueue(req(pkg, 1))
    b.enqueue(req(pkg, 2, kind="topk", k=4))
    b.enqueue(req(pkg, 3))
    first = b.flush_once(force=True)         # oldest head wins: lookup lane
    second = b.flush_once(force=True)
    b.collect_inflight()
    assert [r.kind for r in first] == ["lookup", "lookup"]
    assert [r.seq for r in first] == [0, 2]
    assert [r.kind for r in second] == ["topk"]
    assert ex.batches[1][1] == 4             # k rides the lane
    with pytest.raises(ValueError):
        pkg.batcher.Request("scan", np.zeros(SIGMA, np.int32), 1)


# -------------------------------------------------- cancelled never padded in

def test_cancelled_request_never_enters_device_batch(pkg):
    ex = RecordingExecutor()
    b = pkg.batcher.ContinuousBatcher(ex, buckets=(4, 8), deadline_s=10.0,
                                      autostart=False)
    reqs = [req(pkg, t + 1) for t in range(5)]
    for r in reqs:
        b.enqueue(r)
    assert reqs[1].cancel() and reqs[4].cancel()
    batch = b.flush_once(force=True)
    b.collect_inflight()
    assert [r.seq for r in batch] == [0, 2, 3]
    _, _, g, _ = ex.batches[0]
    assert g.shape[0] == 4                   # bucket chosen after the filter
    np.testing.assert_array_equal(g[:, 0], [1, 3, 4, 0])
    assert reqs[1].future.cancelled() and reqs[4].future.cancelled()
    assert b.stats()["cancelled_dropped"] == 2
    assert b.depth == 0


def test_cancel_refused_with_followers_and_after_delivery(pkg):
    r = req(pkg, 1)
    rider = Future()
    assert r.attach(rider)
    assert not r.cancel()                    # a follower still needs the row
    r.deliver(np.int64(7))
    assert rider.result(0) == 7
    assert not r.cancel()                    # sealed
    assert not r.attach(rider)               # late duplicate must re-submit


def test_executor_errors_reach_every_request(pkg):
    class Failing(RecordingExecutor):
        def submit(self, *a):
            raise RuntimeError("device lost")

    b = pkg.batcher.ContinuousBatcher(Failing(), buckets=(4,), deadline_s=10.0,
                                      autostart=False)
    reqs = [req(pkg, t + 1) for t in range(2)]
    for r in reqs:
        b.enqueue(r)
    b.flush_once(force=True)
    for r in reqs:
        with pytest.raises(RuntimeError, match="device lost"):
            r.future.result(0)


# ------------------------------------------------------------------ admission

def test_token_bucket_exhaustion_and_recovery(pkg):
    t = [0.0]
    bucket = pkg.admission.TokenBucket(rate=2.0, burst=4.0, clock=lambda: t[0])
    assert all(bucket.try_take() for _ in range(4))
    assert not bucket.try_take()             # burst drained
    t[0] += 1.0                              # +2 tokens
    assert bucket.try_take() and bucket.try_take()
    assert not bucket.try_take()
    t[0] += 100.0                            # refill clamps at burst
    assert sum(bucket.try_take() for _ in range(10)) == 4
    with pytest.raises(ValueError):
        pkg.admission.TokenBucket(rate=0.0, burst=1.0)


def test_admission_priority_shedding_tiers(pkg):
    A = pkg.admission
    adm = A.AdmissionController(queue_budget=4, hard_limit=8)
    lo, hi = adm.level("batch"), adm.level("interactive")
    assert adm.admit(tenant="t", level=lo, queue_depth=3) == A.ADMIT
    assert adm.admit(tenant="t", level=lo, queue_depth=4) == A.SHED
    assert adm.admit(tenant="t", level=hi, queue_depth=4) == A.ADMIT
    assert adm.admit(tenant="t", level=hi, queue_depth=8) == A.SHED
    with pytest.raises(KeyError):
        adm.level("vip")
    with pytest.raises(ValueError):
        A.AdmissionController(queue_budget=4, hard_limit=2)
    assert A.AdmissionController(queue_budget=3).describe() == \
        jadmission.AdmissionController(queue_budget=3).describe()


def test_admission_quota_is_per_tenant_and_recovers(pkg):
    A = pkg.admission
    t = [0.0]
    adm = A.AdmissionController(queue_budget=64, quota_rate=1.0, quota_burst=2.0,
                                clock=lambda: t[0])
    assert adm.admit(tenant="a", level=0, queue_depth=0) == A.ADMIT
    assert adm.admit(tenant="a", level=0, queue_depth=0) == A.ADMIT
    assert adm.admit(tenant="a", level=0, queue_depth=0) == A.QUOTA
    assert adm.admit(tenant="b", level=0, queue_depth=0) == A.ADMIT  # own bucket
    t[0] += 1.0
    assert adm.admit(tenant="a", level=0, queue_depth=0) == A.ADMIT  # recovered
    assert adm.admit(tenant="a", level=0, queue_depth=0) == A.QUOTA


# ---------------------------------------------------------------- frontend

def test_frontend_shed_and_quota_tickets(pkg, reg):
    fe = make_frontend(pkg, queue_budget=0, hard_limit=1, quota_rate=1.0,
                       quota_burst=1.0)
    t_batch = fe.submit("lookup", [5], 1, priority="batch")
    assert t_batch.status == "shed" and not t_batch.admitted
    t_hi = fe.submit("lookup", [5], 1, priority="interactive")
    assert t_hi.status == "admitted"         # level 0 survives the soft budget
    assert fe.submit("lookup", [6], 1).status == "shed"   # depth 1 >= hard limit
    assert fe.batcher.depth == 1             # shed requests never queued
    fe.batcher.stop()
    assert reg.counter("frontend.shed").value == 2
    assert reg.counter("frontend.requests").value == 3


def test_frontend_quota_rejection_counter(pkg, reg):
    fe = make_frontend(pkg, queue_budget=64, quota_rate=0.001, quota_burst=1.0)
    assert fe.submit("lookup", [1], 1, tenant="t0").status == "admitted"
    assert fe.submit("lookup", [2], 1, tenant="t0").status == "quota"
    assert fe.submit("lookup", [2], 1, tenant="t1").status == "admitted"
    fe.batcher.stop()
    assert reg.counter("frontend.quota_rejected").value == 1


def test_duplicate_coalescing_identical_payloads(pkg, reg):
    fe = make_frontend(pkg, queue_budget=64)
    a = fe.submit("lookup", [7, 8], 2)
    b = fe.submit("lookup", [7, 8], 2)       # identical, in flight
    c = fe.submit("lookup", [7, 9], 2)       # different gram
    assert (a.status, b.status, c.status) == ("admitted", "coalesced", "admitted")
    fe.batcher.flush_once(force=True)
    fe.batcher.collect_inflight()
    pa, pb = a.future.result(0), b.future.result(0)
    assert pa == pb and pa.tobytes() == pb.tobytes()
    _, _, g, _ = fe.batcher.executor.batches[0]
    assert g.shape[0] == 16                  # one slot for the duplicate pair
    np.testing.assert_array_equal(g[:3, 0], [7, 7, 0])
    fe.batcher.stop()
    assert reg.counter("frontend.coalesced").value == 1
    assert reg.counter("frontend.batches").value == 1
    assert reg.histogram("frontend.batch_fill").count == 1


def test_coalescing_key_includes_generation(pkg):
    fe = make_frontend(pkg, queue_budget=64)
    a = fe.submit("lookup", [7], 1)
    fe.service.gen.generation += 1           # an ingest swapped the index
    b = fe.submit("lookup", [7], 1)
    assert a.status == "admitted" and b.status == "admitted"
    fe.batcher.stop()


def test_overlong_query_is_exact_miss_without_device(pkg):
    fe = make_frontend(pkg, queue_budget=64)
    t = fe.submit("lookup", list(range(1, SIGMA + 2)), SIGMA + 1)
    assert t.status == "admitted" and int(t.future.result(0)) == 0
    row = fe.submit("topk", list(range(1, SIGMA + 1)), SIGMA, k=4)
    np.testing.assert_array_equal(row.future.result(0), np.zeros(2 + 8))
    assert fe.batcher.depth == 0             # nothing queued
    fe.batcher.stop()


def test_trivial_payloads_carry_the_service_dtypes():
    """The port's over-long answers are int64, as its service's answers are;
    ``repro``'s are uint32, as its service's are; the values are equal."""
    for p, dtype in ((PACKAGES["port"], np.int64), (PACKAGES["repro"], np.uint32)):
        fe = make_frontend(p, queue_budget=64)
        lk = fe.submit("lookup", [1] * (SIGMA + 1), SIGMA + 1).future.result(0)
        tk = fe.submit("topk", [1] * SIGMA, SIGMA, k=2).future.result(0)
        assert lk.dtype == dtype and tk.dtype == dtype and tk.shape == (6,)
        assert int(lk) == 0 and not tk.any()
        fe.batcher.stop()


def test_call_many_and_ttfb_histogram(pkg, reg):
    fe = pkg.frontend.QueryFrontend(stub_service(pkg), executor=RecordingExecutor(),
                                    deadline_s=0.001)
    try:
        grams = np.asarray([[4, 0, 0], [5, 6, 0], [4, 0, 0]], np.int32)
        statuses, payloads = fe.call_many("lookup", grams, [1, 2, 1])
        assert [int(p) for p in payloads] == [401, 502, 401]
        assert set(statuses) <= {"admitted", "coalesced"}
        status, payload = fe.call("lookup", [9], 1)
        assert (status, int(payload)) == ("admitted", 901)
        assert reg.histogram("frontend.ttfb_seconds").count == 1
    finally:
        fe.close()


# --------------------------------------------------------------------------- #
# end to end over localhost HTTP: the port's server against repro's
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def servers():
    """A ``repro`` server and a port server (CPU) over the same 1,500 tokens."""
    from repro.core.stats import NGramConfig as JConfig
    from repro_torch.core import NGramConfig

    rng = np.random.default_rng(7)
    tokens = rng.integers(1, VOCAB + 1, 1500).astype(np.int32)
    out = {}
    for name, svc in (
            ("repro", jservice.StreamingNGramService(
                JConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), cache_capacity=4096)),
            ("port", service.StreamingNGramService(
                NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), cache_capacity=4096,
                device="cpu"))):
        svc.ingest(tokens)
        p = PACKAGES[name]
        fe = p.frontend.QueryFrontend(svc, deadline_s=0.002)
        srv = p.http.serve_http(fe, "127.0.0.1", 0, block=False)
        out[name] = SimpleNamespace(svc=svc, fe=fe, srv=srv, addr=srv.server_address)
    try:
        yield out
    finally:
        for s in out.values():
            s.srv.shutdown()
            s.srv.server_close()
            s.fe.close()


def _request(addr, method, path, body=None, headers=None, raw=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        data = raw if raw is not None else (None if body is None else json.dumps(body))
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read().decode()
    finally:
        conn.close()


def both(servers, method, path, body=None, headers=None, raw=None):
    """(port, repro) responses to one request; each a (status, type, body)."""
    return tuple(_request(servers[n].addr, method, path, body, headers, raw)
                 for n in ("port", "repro"))


def assert_same_json(servers, method, path, body=None, headers=None, raw=None):
    port, jax_side = both(servers, method, path, body, headers, raw)
    assert port[:2] == jax_side[:2], (path, body, port, jax_side)
    assert json.loads(port[2]) == json.loads(jax_side[2]), (path, body)
    return port[0], json.loads(port[2])


def test_padded_slots_answered_and_cached_as_repro():
    """Manual flushes over real services of both packages: the batcher pads
    each bucket with zero rows of length 0, both services answer and cache
    those rows (the ``(0, b"")`` key), and the payloads, cache snapshots
    and topology caches are equal."""
    from repro.core.stats import NGramConfig as JConfig
    from repro_torch.core import NGramConfig
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, VOCAB + 1, 1500).astype(np.int32)
    queries = [("lookup", [1, 2], 2, 8), ("lookup", [3], 1, 8), ("topk", [4], 1, 4),
               ("lookup", [5, 6, 7], 3, 8), ("topk", [], 0, 4), ("lookup", [1, 2], 2, 8)]
    seen = []
    for name, svc in (
            ("port", service.StreamingNGramService(
                NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), device="cpu")),
            ("repro", jservice.StreamingNGramService(
                JConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB)))):
        svc.ingest(tokens)
        fe = PACKAGES[name].frontend.QueryFrontend(svc, deadline_s=10.0, autostart=False)
        tickets = [fe.submit(kind, g, n, k=k) for kind, g, n, k in queries]
        while fe.batcher.flush_once(force=True) is not None:
            pass
        fe.batcher.collect_inflight()
        payloads = [np.asarray(t.future.result(0)).tolist() for t in tickets]
        topo = fe.topology()
        fe.close()
        seen.append((payloads, [t.status for t in tickets], svc.cache.snapshot(),
                     topo["cache"], topo["batcher"]))
        assert (0, b"") in svc.cache._d           # the padded slots' key
    assert seen[0] == seen[1]
    assert seen[0][4]["padded_slots"] > 0


def test_http_lookup_bodies_equal_repro(servers):
    from repro_torch.index.merge import segment_to_stats
    svc = servers["port"].svc
    stats = segment_to_stats(svc.gen.segments[0].to_segment())
    grams = np.asarray(stats.grams)[:40].astype(np.int32)
    lengths = np.asarray(stats.lengths)[:40].astype(np.int32)
    direct = svc.lookup(grams, lengths)
    for i in range(8):
        status, body = assert_same_json(servers, "POST", "/v1/lookup",
                                        {"gram": grams[i, :lengths[i]].tolist()})
        assert status == 200 and body["count"] == int(direct[i]) > 0
    miss = [[29, 29, 29], [0], [], [1, 2, 3, 4], [VOCAB + 1], [-3, 2]]
    status, body = assert_same_json(servers, "POST", "/v1/lookup", {
        "grams": [grams[i, :lengths[i]].tolist() for i in range(40)] + miss})
    assert status == 200 and body["counts"][:40] == direct.tolist()
    # explicit lengths: a gram longer than sigma is an exact miss
    status, body = assert_same_json(servers, "POST", "/v1/lookup", {
        "grams": [grams[0, :lengths[0]].tolist(), [1, 2]], "lengths": [int(lengths[0]), 9]})
    assert body["counts"] == [int(direct[0]), 0]
    assert body["generation"] == svc.gen.generation


def test_http_topk_bodies_equal_repro(servers):
    for prefix in ([], [1], [2], [5], [11], [VOCAB], [3, 4], [1, 2, 3], [VOCAB + 5]):
        for k in (1, 4, 8):
            status, body = assert_same_json(servers, "POST", "/v1/topk",
                                            {"prefix": prefix, "k": k})
            assert status == 200 and len(body["terms"]) == k


@pytest.mark.parametrize("prefix,steps,k", [([3], 6, 4), ([1, 2], 12, 2), ([], 3, 8),
                                            ([VOCAB + 1], 4, 4)])
def test_http_sse_completion_equal_repro_and_the_greedy_oracle(servers, prefix, steps, k):
    port, jax_side = both(servers, "POST", "/v1/complete",
                          {"prefix": prefix, "steps": steps, "k": k})
    assert port == jax_side
    assert port[0] == 200 and port[1] == "text/event-stream"
    events = [ln[6:] for ln in port[2].split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    got = [(e["term"], e["count"]) for e in map(json.loads, events[:-1])]
    svc, want, ctx = servers["port"].svc, [], list(prefix)
    for _ in range(steps):                   # direct-call greedy oracle
        w = ctx[-(SIGMA - 1):]
        pg = np.zeros((1, SIGMA), np.int32)
        pg[0, :len(w)] = w
        row = svc.continuations(pg, np.array([len(w)], np.int32), k=k)[0]
        if int(row[2 + k]) == 0:
            break
        want.append((int(row[2]), int(row[2 + k])))
        ctx.append(int(row[2]))
    assert got == want


@pytest.mark.parametrize("method,path,body,headers,raw", [
    ("GET", "/nope", None, None, None),
    ("POST", "/nope", {}, None, None),
    ("POST", "/v1/lookup", {"gram": "abc"}, None, None),
    ("POST", "/v1/lookup", {"gram": [1, True]}, None, None),
    ("POST", "/v1/lookup", {"grams": [[1]], "lengths": [1, 2]}, None, None),
    ("POST", "/v1/lookup", {"gram": [1]}, {"X-Priority": "vip"}, None),
    ("POST", "/v1/lookup", None, None, "{not json"),
    ("POST", "/v1/lookup", None, None, "[1, 2]"),
    ("POST", "/v1/topk", {"prefix": [1], "k": 0}, None, None),
    ("POST", "/v1/topk", {"prefix": [1], "k": 65}, None, None),
    ("POST", "/v1/complete", {"prefix": [1], "steps": 0}, None, None),
    ("POST", "/v1/complete", {"prefix": [1], "k": "x"}, None, None),
    ("GET", "/healthz", None, None, None),
])
def test_http_error_paths_equal_repro(servers, method, path, body, headers, raw):
    assert_same_json(servers, method, path, body, headers, raw)


def test_http_topology_equal_repro_but_devices_and_flat_bytes(servers):
    port = json.loads(_request(servers["port"].addr, "GET", "/v1/system/topology")[2])
    want = json.loads(_request(servers["repro"].addr, "GET", "/v1/system/topology")[2])
    svc = servers["port"].svc
    assert port["devices"] == {"backend": "cuda" if torch.cuda.is_available() else "cpu",
                               "count": torch.cuda.device_count()}
    assert port["index"]["nbytes"] == svc.gen.nbytes
    assert [s["nbytes"] for s in port["index"]["segments"]] == \
        [ix.nbytes for ix in svc.gen.levels]
    for topo in (port, want):
        del topo["devices"], topo["index"]["nbytes"]
        for seg in topo["index"]["segments"]:
            del seg["nbytes"]
        # the batcher's counters depend on how requests happened to coalesce
        for key in ("batches", "requests", "wait_cycles", "padded_slots"):
            del topo["batcher"][key]
    port_cache, want_cache = port.pop("cache"), want.pop("cache")
    assert port == want
    assert port_cache.keys() == want_cache.keys()
    assert port["index"]["kind"] == "generational"
    assert [s["rows"] for s in port["index"]["segments"]] == list(svc.gen.level_rows)


def test_describe_topology_of_one_index_as_repro():
    """A single frozen index, flat and compressed: ``repro``'s description
    but for the flat layout's bytes (int64 lanes); compressed bytes at rest
    are equal."""
    from repro.core import run_job as jrun
    from repro.core.stats import NGramConfig as JConfig
    from repro.index import build_compressed_index as jcbuild
    from repro.index import build_index as jbuild
    from repro.index.serve import describe_topology as jdescribe
    from repro_torch.core import NGramConfig, run_job
    from repro_torch.index import build_compressed_index, build_index
    from repro_torch.index.serve import describe_topology
    toks = np.random.default_rng(2).integers(0, VOCAB + 1, 2000).astype(np.int32)
    stats = run_job(toks, NGramConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB), device="cpu")
    jstats = jrun(toks, JConfig(sigma=SIGMA, tau=1, vocab_size=VOCAB))
    flat = build_index(stats, vocab_size=VOCAB, device="cpu")
    comp = build_compressed_index(stats, vocab_size=VOCAB, device="cpu")
    jflat = jbuild(jstats, vocab_size=VOCAB)
    jcomp = jcbuild(jstats, vocab_size=VOCAB)
    for ix, jix in ((flat, jflat), (comp, jcomp)):
        got, want = describe_topology(ix), jdescribe(jix)
        assert got == {"kind": "index", "rows": want["rows"], "nbytes": ix.nbytes}
        assert want["kind"] == "index" and got["rows"] == len(stats)
    assert comp.nbytes_at_rest == jcomp.nbytes_at_rest


def test_http_shed_maps_to_503_and_quota_to_429(pkg):
    fe = pkg.frontend.QueryFrontend(
        stub_service(pkg), executor=RecordingExecutor(),
        admission=pkg.admission.AdmissionController(queue_budget=0, hard_limit=0),
        deadline_s=10.0, autostart=False)
    srv = pkg.http.serve_http(fe, "127.0.0.1", 0, block=False)
    try:
        status, _, body = _request(srv.server_address, "POST", "/v1/lookup", {"gram": [1]})
        assert status == 503 and "shed" in json.loads(body)["error"]
        status, _, body = _request(srv.server_address, "POST", "/v1/complete",
                                   {"prefix": [1], "steps": 3})
        assert status == 200 and '{"error": "shed"}' in body and body.endswith("[DONE]\n\n")
    finally:
        srv.shutdown()
        srv.server_close()
        fe.batcher.stop()
    fe = pkg.frontend.QueryFrontend(
        stub_service(pkg), executor=RecordingExecutor(),
        admission=pkg.admission.AdmissionController(quota_rate=0.001, quota_burst=1.0),
        deadline_s=0.001)
    srv = pkg.http.serve_http(fe, "127.0.0.1", 0, block=False)
    try:
        codes = [_request(srv.server_address, "POST", "/v1/topk", {"prefix": [t]},
                          headers={"X-Tenant": "t0"})[0] for t in (1, 2)]
        assert codes == [200, 429]
    finally:
        srv.shutdown()
        srv.server_close()
        fe.close()


def test_request_and_flush_spans_recorded(servers):
    addr = servers["port"].addr
    tracer = trace.enable_tracing()
    try:
        status, _, _ = _request(addr, "POST", "/v1/lookup", {"gram": [2, 4]})
        assert status == 200
    finally:
        trace.disable_tracing()
    names = {e["name"] for e in tracer.export()["traceEvents"]}
    assert {"serve.request", "serve.flush"} <= names   # transport and batcher threads


def test_launch_reexports():
    from repro_torch.launch import serve_ngrams as mod
    from repro_torch.pipeline.executor import DoubleBufferedDriver
    from repro_torch.serve.cache import LRUQueryCache
    assert mod.LRUQueryCache is LRUQueryCache
    assert mod.StreamingNGramService is service.StreamingNGramService
    assert mod.microbatch_drive is service.microbatch_drive
    assert mod.make_query_stream is service.make_query_stream
    assert mod.DoubleBufferedDriver is DoubleBufferedDriver
    with pytest.raises(AttributeError):
        mod.not_a_thing


def test_microbatch_drive_as_repro(pkg, reg):
    """The same answer function through both drivers: the same batch count in
    the histogram and every batch answered, the tail padded with zero rows."""
    seen = []

    def answer(g, ln):
        seen.append((g.copy(), ln.copy()))
        return ln

    grams = np.arange(30, dtype=np.int32).reshape(10, 3)
    lengths = np.arange(10, dtype=np.int32)
    qps, lat = pkg.service.microbatch_drive(answer, grams, lengths, 4, warmup=1)
    assert len(lat) == 3 and qps > 0
    assert reg.histogram("drive.batch_seconds").count == 3
    assert len(seen) == 4                    # one warm-up, three timed
    np.testing.assert_array_equal(seen[-1][1], [8, 9, 0, 0])
