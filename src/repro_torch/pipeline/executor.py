"""Job execution on one device (port of the single-device parts of
``repro.pipeline.executor``): the monolithic ``run_plan`` and the wave
engine ``WaveExecutor``.

``run_plan`` runs a :class:`~repro_torch.pipeline.plan.JobPlan` over the
whole corpus at once, on the device the tokens lie on: every round's map
emit, then the stage core (combine -> shuffle key and skew histogram -> sort
-> reduce), then a host materialize into ``NGramStats``.  Output rows are in
canonical order (``stages.canonical_stats``) and the counters are exactly
``repro``'s.  The multi-round plans (APRIORI-SCAN/-INDEX) hand each round's
carry to the next here.

``WaveExecutor`` streams a host-resident corpus through the device in
fixed-size waves, each with a sigma - 1 token halo, at ``tau = 1``, and
folds the waves' sorted segments (``index.merge``'s accumulators) on a
background thread while the next waves run; the global tau applies once at
the end, so its output equals ``run_plan``'s array for array.
``run_streaming`` ingests each wave into a ``GenerationalIndex`` instead.

With a :class:`~repro_torch.launch.mesh.DataMesh` of more than one rank
(the mesh waves, port of ``repro``'s ``shard_map`` waves), every rank runs
``WaveExecutor(cfg, mesh=mesh, ...).run(tokens)`` with the whole corpus and
takes its row of each wave's ``[P, n_local]`` split, a sigma - 1 halo from
the next rank, and every round's hash-partitioned exchange; the shuffle
sends all evidence of a gram to one rank, so each rank folds its own rows
and :meth:`WaveExecutor.run` gathers the folded parts once at the end.  Two
differences in form from ``repro``: a wave fits its rounds' capacities
before it exchanges anything (one reduction of each round's largest part,
doubling the wave's sticky scale), where ``repro`` runs the whole wave,
reads the overflow sum and reruns it at double scale; and one all-to-all
moves every round's buckets, where ``repro``'s program exchanges round by
round.  Both reach the same scale and the same ``retries`` (``repro``'s
with ``overlap=False``; with the fold thread its count depends on thread
timing), and no overflowing buffer is sent, so ``shuffle(reduce_overflow=)``
has no use here.

Spans ``plan.run`` and ``round.{emit,stages,materialize}`` mark the
monolithic job's phases; ``round.materialize`` also covers the next round's
carry, ``stage.{combine,partition,sort,reduce}`` split ``round.stages``,
and ``stages.canonical`` is the host finish.  PyTorch launches
asynchronously, so with tracing on these spans synchronize the card at
their close: their durations then cover the device work they launched.  The
wave spans (``wave.run``, ``wave.window.pad``, ``wave.window.h2d``,
``wave.submit`` with one ``round.stages`` a wave and the stage spans of its
rounds inside, ``wave.collect``, ``wave.fold``, ``wave.finalize``; on a mesh
``wave.mesh.dispatch``, ``wave.mesh.retry`` and ``wave.mesh.collect`` for
the submit and collect) do not: a wave's dispatch must not wait for the
card, and its collect waits by itself.
"""
from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from repro_torch import resolve_device, u32_words
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import mesh_size
from repro_torch.mapreduce import pack as packing
from repro_torch.mapreduce import shuffle as mr_shuffle
from repro_torch.mapreduce import sort as mr_sort
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.pipeline import stages
from repro_torch.pipeline.plan import JobPlan, plan_for

_SKEW_BUCKETS = 64   # nominal reducer count for the shuffle-skew counter


def _stage_span(name: str, records):
    """A stage span of the stage core, carrying the records it takes in."""
    sp = obs_trace.span(name)
    if sp:
        sp.set(rows=records.shape[0])
    return sp


def _stage_core_impl(records, valid, *, n_lanes: int, has_bucket: bool,
                     combine_route: str | None, sigma: int, lane_vocab: int,
                     shuffle_key: str, reduce_kind: str,
                     with_positions: bool = False, n_buckets: int = 0,
                     sync: bool = False):
    """combine -> shuffle-key -> sort -> reduce over one round's records.

    ``has_bucket``: the records end with a time-series bucket lane, which the
    combiner keeps apart and ``n_buckets > 0`` counts per bucket.

    Returns (dense reducer outputs, map-record count, post-combine live-record
    count, partition histogram over ``_SKEW_BUCKETS`` nominal reducers, the
    sorted records' key lanes -- the segment collect's raw material); the
    counts stay device tensors until the caller's materialize.  The dense
    outputs of the ``"exact"`` reducer with ``with_positions`` end with the
    run total of every position.

    Each stage runs in a span (``stage.combine``, ``stage.partition``,
    ``stage.sort``, ``stage.reduce``) with the rows it takes in.  ``sync``:
    the spans synchronize the device at their close (the single job's
    rounds); the wave engine enqueues a whole wave and leaves it False.
    """
    with _stage_span("stage.combine", records) as sp:
        map_rec = valid.sum()
        if combine_route is not None:
            records = stages.combine(records, n_lanes, has_bucket,
                                     route=combine_route)
        if sync:
            sp.sync(records)
    with _stage_span("stage.partition", records) as sp:
        live = records[:, n_lanes] > 0
        shuffled = live.sum()
        key = stages.partition_keys(records, n_lanes, kind=shuffle_key,
                                    vocab_size=lane_vocab)
        # the real partitioner's bucketing (hash_u32 % P, invalid -> P), so the
        # skew counter measures realized reducer load, not raw-key spread
        _, hist = kops.hash_partition(key, live, n_parts=_SKEW_BUCKETS)
        if sync:
            sp.sync(hist)
    with _stage_span("stage.sort", records) as sp:
        rec = stages.sort_stage(records, n_keys=n_lanes)
        if sync:
            sp.sync(rec)
    with _stage_span("stage.reduce", rec) as sp:
        if reduce_kind == "suffix":
            dense = stages.reduce_suffix(rec, sigma=sigma, vocab_size=lane_vocab,
                                         n_buckets=n_buckets)
        else:
            dense = stages.reduce_exact(rec, sigma=sigma, vocab_size=lane_vocab,
                                        with_positions=with_positions)
        if sync:
            sp.sync(dense)
    return dense, map_rec, shuffled, hist, rec[:, :n_lanes]


def materialize(dense, tau: int):
    """Dense reducer output -> host ``NGramStats``.

    ``NGramStats.from_dense`` computed on the device, so that only the kept
    (flag, cf >= tau) cells leave it: each cell's row of terms, cut to its
    length, and its count, in ``from_dense``'s row-major order.  Series
    counts [N, sigma, B] are kept by their sum over the buckets, taken in
    int32 as the cells are: an int64 sum would first copy the whole
    [N, sigma, B] tensor to int64.
    """
    from repro_torch.core.stats import NGramStats
    terms, flags, counts = dense
    total = counts.sum(dim=-1, dtype=torch.int32) if counts.dim() == 3 else counts
    rows, lens0 = (flags & (total >= tau)).nonzero().unbind(1)
    lengths = (lens0 + 1).to(torch.int32)
    grams = terms[rows] * (torch.arange(terms.shape[1], device=terms.device)
                           < lengths[:, None])
    return NGramStats(grams.to(torch.int32).cpu().numpy(), lengths.cpu().numpy(),
                      counts[rows, lens0].to(torch.int64).cpu().numpy())


def _run_rounds(tok_ext, aux_ext, n_live: int, cfg, plan: JobPlan,
                tau_eff: int, counters: dict):
    """All of a plan's rounds over one token window -> merged ``NGramStats``."""
    from repro_torch.core.stats import add_counters

    lane_vocab = plan.effective_lane_vocab(cfg)
    n_l = packing.n_lanes(cfg.sigma, lane_vocab)
    has_bucket = aux_ext is not None
    n_meta = plan.map.n_meta + (1 if has_bucket else 0)
    rec_bytes = packing.record_bytes(cfg.sigma, lane_vocab, n_meta=n_meta)
    combine_route = plan.combine.route if plan.combine is not None else None

    out = None
    carry = None
    for k in range(1, plan.rounds + 1):
        with obs_trace.span("round.emit") as sp:
            records, valid, emit_extras = plan.map.emit(
                tok_ext, aux_ext, n_live, cfg, carry, k)
            if sp:
                sp.set(round=k)
                sp.sync(records)
        with obs_trace.span("round.stages") as sp:
            dense, map_rec, shuffled, hist, _ = _stage_core_impl(
                records, valid, n_lanes=n_l, has_bucket=has_bucket,
                combine_route=combine_route,
                sigma=cfg.sigma, lane_vocab=lane_vocab,
                shuffle_key=plan.shuffle.key, reduce_kind=plan.reduce.kind,
                with_positions=plan.reduce.with_positions,
                n_buckets=cfg.n_buckets, sync=True)
            del records, valid
            if sp:
                sp.set(round=k)
                sp.sync(dense)
        with obs_trace.span("round.materialize") as sp:
            if sp:
                sp.set(round=k)
            stats_k = materialize(dense[:3], tau_eff)
            reduce_extras = ({"totals_pos": dense[3]}
                             if plan.reduce.with_positions else {})
            del dense
            last = k == plan.rounds or (plan.stop_on_empty and len(stats_k) == 0)
            if not last and plan.update_carry is not None:
                # the next round's carry; APRIORI-SCAN's copies this round's
                # frequent grams from the host back to the device, as repro does
                carry = plan.update_carry(cfg, tau_eff, k, tok_ext, stats_k,
                                          reduce_extras, emit_extras, carry)
                if sp:
                    sp.sync(carry)
            del reduce_extras, emit_extras
        map_rec = int(map_rec)
        shuffled = int(shuffled)
        hist = hist.cpu().numpy()
        add_counters(counters, jobs=1, map_records=map_rec,
                     shuffle_records=shuffled,
                     shuffle_bytes=shuffled * rec_bytes)
        if shuffled:
            skew = float(hist.max() * _SKEW_BUCKETS / max(hist.sum(), 1))
            counters["shuffle_skew"] = max(counters.get("shuffle_skew", 0.0),
                                           skew)
        out = stats_k if out is None else out.merged_with(stats_k)
        if last:
            break
    out.counters = counters
    return out


def run_plan(tokens: torch.Tensor, cfg, bucket_ids=None,
             plan: JobPlan | None = None):
    """One-wave (whole-corpus) plan execution -- the single-device job.

    ``tokens`` is a 1-D int32 tensor; the job runs on its device.
    ``bucket_ids``: one time-series bucket a position (SSVI-B), read as
    uint32 as ``repro`` reads them; with ``cfg.n_buckets > 0`` the counts
    are per-bucket series.  Output rows are in canonical segment order,
    counters as ``repro``'s ``run_plan``.
    """
    plan = plan or plan_for(cfg)
    with obs_trace.span("plan.run") as sp:
        if sp:
            sp.set(method=cfg.method, rounds=plan.rounds)
        aux = None
        if bucket_ids is not None:
            aux = u32_words(bucket_ids, tokens.device)
            if aux.shape != tokens.shape:
                raise ValueError(f"bucket_ids: one a position, {tuple(tokens.shape)}; "
                                 f"got {tuple(aux.shape)}")
        counters = dict.fromkeys(
            ("jobs", "map_records", "shuffle_records", "shuffle_bytes",
             "retries", "overflow"), 0)
        counters["shuffle_skew"] = 0.0
        out = _run_rounds(tokens, aux, int(tokens.shape[0]), cfg, plan,
                          cfg.tau, counters)
        out.counters = obs_metrics.normalize_counters(out.counters)
        with obs_trace.span("stages.canonical") as sp:
            if sp:
                sp.set(rows=len(out))
            return stages.canonical_stats(out)


# ------------------------------------------------------------------ wave engine
#: waves queued for the fold beyond the one being folded: bounds the device
#: footprint of the overlapped fold at a small constant times a wave's
_WAVES_IN_FLIGHT = 2

#: reducer rows a collect turns into segment candidates at once: a suffix
#: reducer's candidate table has sigma rows a reducer row, so a whole wave's
#: at once would hold sigma x (1 + n_lanes) int64 words a position
_COLLECT_ROWS = 1 << 22


def _wave_rounds(cfg, plan: JobPlan, tok_ext: torch.Tensor, n_live: int) -> list:
    """Enqueue one wave's whole round chain: every round's emit, stage core
    and ``tau_eff == 1`` carry, with no host sync; returns per round (dense
    (terms, flags, counts), map records, shuffled records, skew histogram,
    sorted key lanes), all device tensors.  ``stop_on_empty`` is not taken:
    a round with nothing to emit folds to nothing."""
    lane_vocab = plan.effective_lane_vocab(cfg)
    n_l = packing.n_lanes(cfg.sigma, lane_vocab)
    combine_route = plan.combine.route if plan.combine is not None else None
    carry = None
    rounds = []
    for k in range(1, plan.rounds + 1):
        records, valid, emit_extras = plan.map.emit(tok_ext, None, n_live, cfg,
                                                    carry, k)
        # position payloads feed only the tau > 1 carries: not scattered here
        dense, map_rec, shuffled, hist, lanes = _stage_core_impl(
            records, valid, n_lanes=n_l, has_bucket=False,
            combine_route=combine_route, sigma=cfg.sigma, lane_vocab=lane_vocab,
            shuffle_key=plan.shuffle.key, reduce_kind=plan.reduce.kind)
        del records, valid
        rounds.append((dense[:3], map_rec, shuffled, hist, lanes))
        if k < plan.rounds and plan.update_carry is not None:
            carry = plan.update_carry(cfg, 1, k, tok_ext, None, {}, emit_extras,
                                      carry)
        del emit_extras
    return rounds


class DoubleBufferedDriver:
    """Overlap host-side work with device execution.

    ``submit`` dispatches batch i+1 (``answer`` returns its result
    unmaterialized: device tensors, or a record holding them) and only then
    materializes batch i's through ``collect``, so the host reads the old
    batch while the card runs the new one.  ``submit`` returns (the previous
    batch's collected result, its submit-time ``tag``); ``drain`` flushes
    the last batch in flight.  The wave engine's ``iter_wave_stats`` and the
    service's ``lookup_pipelined`` ride it.  Both batches share one CUDA
    stream, so a collect that reads the card waits for the newer batch too:
    the overlap is the host's dispatch, not the card's work.
    """

    def __init__(self, answer, collect=None):
        self._answer = answer
        self._collect = collect
        self._pending = None

    def _materialize(self, out):
        if self._collect is not None:
            return self._collect(out)
        return out.cpu().numpy()

    def submit(self, *args, tag=None):
        out = self._answer(*args)
        prev, self._pending = self._pending, (out, tag)
        if prev is None:
            return None, None
        return self._materialize(prev[0]), prev[1]

    def drain(self):
        if self._pending is None:
            return None, None
        (out, tag), self._pending = self._pending, None
        return self._materialize(out), tag


class WavePartial:
    """One collected wave: its sorted segment of exact ``tau = 1`` rows in
    (length | packed lanes) order, on the executor's device with no sentinel
    tail; ``n_rows`` its row count; ``counters`` the wave's job counters."""

    __slots__ = ("segment", "n_rows", "counters")

    def __init__(self, segment, n_rows: int, counters: dict):
        self.segment = segment
        self.n_rows = n_rows
        self.counters = counters


def _host_tokens(tokens) -> np.ndarray:
    """The corpus as a host int32 array (a tensor is copied off its device):
    the wave engine keeps the corpus on the host."""
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu().numpy()
    return np.asarray(tokens, np.int32)


class _FoldCollectives:
    """The collectives a mesh run's fold thread needs, issued by the feeder.

    A process group pairs the ranks' collectives by their order, so every
    collective of a mesh run is issued by the one thread that submits the
    waves.  The fold thread's (the tiered accumulator's rung sizes over the
    ranks) come through here: :meth:`sum_int` queues the value and waits,
    and the feeder answers every request of wave w's fold in :meth:`serve`
    before it submits wave w + 2 (the last waves' after its last submit, in
    wave order).  Every rank's fold asks the same questions, since its
    decisions rest on sizes over all ranks, so every rank issues them in the
    same order.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self._requests: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._error: BaseException | None = None

    def sum_int(self, value: int) -> int:
        """The sum of ``value`` over the ranks (called on the fold thread)."""
        reply: queue.Queue = queue.Queue(maxsize=1)
        with self._lock:
            if self._error is not None:
                raise RuntimeError("the feeder thread failed") from self._error
            self._requests.put((value, reply))
        out = reply.get()
        if isinstance(out, BaseException):
            raise RuntimeError("the feeder thread failed") from out
        return out

    def wave_done(self) -> None:
        """Mark the end of one wave's fold (called on the fold thread)."""
        self._requests.put(None)

    def serve(self) -> None:
        """Answer the requests of the next wave's fold, up to its end."""
        while True:
            req = self._requests.get()
            if req is None:
                return
            value, reply = req
            try:
                (total,) = self.mesh.sum_ints(value)
            except BaseException as e:
                reply.put(e)
                raise
            reply.put(total)

    def close(self, error: BaseException) -> None:
        """The feeder failed: fail every request, waiting or to come."""
        with self._lock:
            self._error = error
            while True:
                try:
                    req = self._requests.get_nowait()
                except queue.Empty:
                    return
                if req is not None:
                    req[1].put(error)


class WaveExecutor:
    """Run a :class:`JobPlan` over fixed-size token waves (out of core).

    The corpus stays on the host.  Each wave of ``wave_tokens`` positions
    (``None``, or a wave at least the corpus, is one wave) and a sigma - 1
    token halo from the next is copied to the device from pinned memory,
    and its whole round chain is enqueued with no host sync
    (:meth:`_submit_wave`); a fold thread then collects each wave on the
    card into a sorted segment of its exact ``tau = 1`` rows (nothing may be
    dropped early: a gram below tau in every wave can be frequent in all)
    and folds it under ``accumulator``: ``"defer"`` stacks the partials and
    merges once at the end (the default), ``"tiered"`` keeps size-tiered
    rungs, ``"pairwise"`` folds every wave into one segment.
    ``merge_route`` is ``merge_segments``'s: ``"merge"`` (the ``merge_path``
    tree on the card, the default; ``repro`` defaults to ``"kway"``, which
    in the port folds on the host), ``"device"``, ``"sort"`` or ``"kway"``.
    :meth:`run` applies the global tau once at the end, so for any wave
    size, accumulator and route its output equals the monolithic job's
    (:func:`run_plan`) array for array, and its counters equal ``repro``'s
    ``WaveExecutor.run``: ``jobs`` counts rounds x waves, ``waves`` and
    ``fold_rows`` (the rows fed through merges) are added, and
    ``shuffle_skew`` is the worst wave's.

    ``mesh``: a :class:`~repro_torch.launch.mesh.DataMesh` of more than one
    rank runs the mesh waves (:meth:`_submit_wave_mesh`); every rank calls
    :meth:`run` with the same corpus and gets the same output, equal to the
    single-device run's, counters included.  Each rank folds the rows its
    exchanges brought it; the tiered accumulator decides on rung sizes over
    all ranks, so the ranks' ``fold_rows`` sum to the one fold's.  Every
    collective runs on the thread that submits the waves (the fold thread's
    sizes through :class:`_FoldCollectives`).  ``shuffle_skew`` is measured
    only while a metrics registry is set on some rank, as in ``repro``.

    Device memory: O(wave * sigma) records per wave in flight (at most
    ``_WAVES_IN_FLIGHT`` queued beside the one folding), plus the running
    segments, which hold the exact gram set seen so far (on a mesh, the
    rank's part of it).  Waves take no bucketed series (``n_buckets``).
    Runs on the card unless ``device`` says otherwise.
    """

    #: doublings of a wave's capacity scale before a mesh wave gives up
    MAX_RETRIES = 5

    def __init__(self, cfg, *, wave_tokens: int | None = None,
                 plan: JobPlan | None = None, merge_route: str = "merge",
                 accumulator: str = "defer", mesh=None, overlap: bool = True,
                 device=None):
        if wave_tokens is not None and wave_tokens < 1:
            raise ValueError("wave_tokens must be >= 1")
        if cfg.n_buckets:
            raise ValueError("wave execution does not support n_buckets "
                             "(bucketed series need the bucket-carrying "
                             "single job -- run_job / run_plan)")
        if accumulator not in ("defer", "tiered", "pairwise"):
            raise ValueError(f"unknown accumulator {accumulator!r} "
                             "(options: 'defer', 'tiered', 'pairwise')")
        self.cfg = cfg
        self.wave_tokens = wave_tokens
        self.plan = plan or plan_for(cfg)
        self.merge_route = merge_route
        self.accumulator = accumulator
        self.mesh = mesh
        # overlap: collect and fold each wave on a background thread (and,
        # on the card, its own stream) while the next waves run; False
        # serializes dispatch and fold on the calling thread
        self.overlap = overlap
        self.device = resolve_device(device)
        # the direct segment collect needs the record lanes packed in the
        # segment layout, i.e. at cfg.vocab_size; other plans take the
        # stats route
        self._direct = self.plan.effective_lane_vocab(cfg) == cfg.vocab_size
        # the mesh waves' capacity scale: doubles when a round's largest
        # part outgrows it and sticks, so later waves start at the proven one
        self._mesh_scale = 1
        self._with_skew = False

    @property
    def _use_mesh(self) -> bool:
        return mesh_size(self.mesh) > 1

    # --- wave iteration ---------------------------------------------------- #

    def _windows(self, tokens: np.ndarray, *, to_device: bool = True):
        """Yield (host slab, tok_ext [wave + sigma - 1] on the device, n_live).

        The corpus is padded once into pinned memory (on the card), and each
        slab is copied with ``non_blocking``; the caller keeps the slab until
        the wave's event has fired.  ``n_live`` is the wave's true token
        count: the last wave of a corpus that is not a multiple of the wave
        gets a partial one, so its emit masks the zero-padded tail.
        ``to_device=False`` yields no device window (``None``): the mesh
        waves copy only the rank's row of the slab.
        """
        n = int(tokens.shape[0])
        wave = self.wave_tokens if self.wave_tokens is not None else n
        wave = max(1, min(wave, n) if n else 1)
        n_waves = max(1, -(-n // wave))
        halo = self.cfg.sigma - 1
        with obs_trace.span("wave.window.pad") as sp:
            if sp:
                sp.set(n_waves=n_waves, wave_tokens=wave)
            padded = torch.zeros((n_waves * wave + halo,), dtype=torch.int32,
                                 pin_memory=self.device.type == "cuda")
            padded.numpy()[:n] = tokens
        for w in range(n_waves):
            n_live = max(0, min(wave, n - w * wave))
            slab = padded[w * wave: (w + 1) * wave + halo]
            tok_ext = None
            if to_device:
                with obs_trace.span("wave.window.h2d") as sp:
                    if sp:
                        sp.set(wave=w)
                    tok_ext = slab.to(self.device, non_blocking=True)
            yield slab, tok_ext, n_live

    # --- dispatch and collect ---------------------------------------------- #

    def _submit_wave(self, tok_ext: torch.Tensor, n_live: int, slab=None) -> dict:
        """Enqueue one wave's round chain; nothing materializes here.

        The wave runs at ``tau_eff = 1``, where every carry is a function of
        the emit's own evidence, so rounds, carries and counters stay on the
        device until :meth:`_collect_wave`.  On the card a CUDA event marks
        the wave's end: the collect waits for it alone, not for the waves
        enqueued after it.  ``slab``, the wave's pinned host tokens, rides
        along until the collect.  A mesh wave goes to
        :meth:`_submit_wave_mesh`.
        """
        if self._use_mesh:
            return self._submit_wave_mesh(slab, n_live)
        cfg, plan = self.cfg, self.plan
        with obs_trace.span("wave.submit") as sp:
            if sp:
                sp.set(n_live=n_live, rounds=plan.rounds)
            # one span a wave, whatever the rounds: the chain is one dispatch
            with obs_trace.span("round.stages") as sp_s:
                if sp_s:
                    sp_s.set(fused_rounds=plan.rounds)
                rounds = _wave_rounds(cfg, plan, tok_ext, n_live)
            rec_bytes = packing.record_bytes(
                cfg.sigma, plan.effective_lane_vocab(cfg), n_meta=plan.map.n_meta)
            return {"rounds": rounds, "rec_bytes": rec_bytes,
                    "done": self._wave_event(tok_ext), "slab": slab}

    @staticmethod
    def _wave_event(t: torch.Tensor):
        """On the card, a CUDA event recorded after the wave's work."""
        if not t.is_cuda:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        return done

    @staticmethod
    def _await(pend: dict) -> None:
        """Order the current stream after the wave's event, and mark the
        wave's tensors as in use there, so the caching allocator does not
        hand their memory to the wave's own stream while this one reads it."""
        done = pend["done"]
        if done is None:
            return
        stream = torch.cuda.current_stream()
        stream.wait_event(done)
        for (terms, flags, counts), *rest in pend["rounds"]:
            for t in (terms, flags, counts, *rest):
                t.record_stream(stream)
        if "rows" in pend:
            pend["rows"].record_stream(stream)

    @staticmethod
    def _wave_counters(pend: dict) -> dict:
        """The wave's job counters, read from the device in one copy."""
        from repro_torch.core.stats import add_counters
        rounds = pend["rounds"]
        host = torch.stack([torch.cat([m.view(1), s.view(1), h.to(torch.int64)])
                            for _, m, s, h, _ in rounds]).cpu().numpy()
        counters: dict = {}
        for row in host:
            shuffled = int(row[1])
            hist = row[2:]
            add_counters(counters, jobs=1, map_records=int(row[0]),
                         shuffle_records=shuffled,
                         shuffle_bytes=shuffled * pend["rec_bytes"])
            if shuffled:
                skew = float(hist.max() * _SKEW_BUCKETS / max(hist.sum(), 1))
                counters["shuffle_skew"] = max(counters.get("shuffle_skew", 0.0),
                                               skew)
        return counters

    def _collect_wave(self, pend: dict):
        """Materialize a submitted wave -> its exact ``NGramStats`` partial."""
        if pend.get("mesh"):
            return self._collect_wave_mesh(pend)
        with obs_trace.span("wave.collect") as sp:
            self._await(pend)
            counters = self._wave_counters(pend)
            out = None
            for dense, *_ in pend["rounds"]:
                stats_k = materialize(dense, 1)
                out = stats_k if out is None else out.merged_with(stats_k)
            out.counters = counters
            if sp:
                sp.set(rows=len(out), shuffle_records=counters.get(
                    "shuffle_records", 0))
            return out

    def _partial_from_stats(self, wave_stats) -> WavePartial:
        """Freeze an ``NGramStats`` wave partial (the stats route)."""
        from repro_torch.index.build import segment_from_wave_stats
        seg = segment_from_wave_stats(wave_stats, vocab_size=self.cfg.vocab_size,
                                      device=self.device)
        return WavePartial(seg, len(wave_stats), wave_stats.counters)

    def _candidate_rows(self, rounds) -> tuple[torch.Tensor, torch.Tensor]:
        """The kept (key, count) rows of a wave's rounds, unsorted: each
        round's (flags, counts, sorted key lanes) become packed candidate
        rows (``stages.segment_candidates``, ``_COLLECT_ROWS`` reducer rows
        at a time), compacted to the live ones."""
        from repro_torch.core.common import prefix_masks
        cfg = self.cfg
        masks = prefix_masks(cfg.sigma, cfg.vocab_size, self.device)
        key_parts, cnt_parts = [], []
        for flags, counts, lanes in rounds:
            for r0 in range(0, max(lanes.shape[0], 1), _COLLECT_ROWS):
                rows = slice(r0, r0 + _COLLECT_ROWS)
                keys, cnts = stages.segment_candidates(
                    flags[rows], counts[rows], lanes[rows], masks,
                    sigma=cfg.sigma, reduce_kind=self.plan.reduce.kind)
                live = cnts > 0
                key_parts.append(keys[live])
                cnt_parts.append(cnts[live])
                del keys, cnts, live
        return torch.cat(key_parts), torch.cat(cnt_parts)

    def _sorted_partial(self, keys: torch.Tensor, cnts: torch.Tensor,
                        counters: dict) -> WavePartial:
        """A wave's kept rows sorted into its segment (every key unique)."""
        from repro_torch.index.build import IndexSegment
        keys, (cnts,) = mr_sort.sort_with_payload(keys, [cnts])
        seg = IndexSegment(keys=keys, counts=cnts, sigma=self.cfg.sigma,
                           vocab_size=self.cfg.vocab_size)
        return WavePartial(seg, int(keys.shape[0]), counters)

    def _collect_wave_segment(self, pend: dict) -> WavePartial:
        """Collect a submitted wave straight into a sorted segment, on its
        device.

        Each round's reducer output becomes packed candidate rows
        (:meth:`_candidate_rows`); the kept rows of every round are sorted
        by ``mapreduce.sort``'s lexicographic order.
        Every kept key of a wave is unique (rounds emit disjoint lengths, and
        a sorted reducer block flags each run once), so the order is a pure
        function of the row set and equals ``repro``'s host collect, and the
        stats route's (``segment_from_wave_stats``), row for row.  Plans
        whose lanes pack with another vocabulary take the stats route.  A
        mesh wave goes to :meth:`_collect_wave_segment_mesh`.
        """
        if pend.get("mesh"):
            return self._collect_wave_segment_mesh(pend)
        if not self._direct:
            return self._partial_from_stats(self._collect_wave(pend))
        with obs_trace.span("wave.collect") as sp:
            self._await(pend)
            counters = self._wave_counters(pend)
            keys, cnts = self._candidate_rows(
                [(flags, counts, lanes)
                 for (_, flags, counts), _, _, _, lanes in pend["rounds"]])
            part = self._sorted_partial(keys, cnts, counters)
            del keys, cnts
            if sp:
                sp.set(rows=part.n_rows, shuffle_records=counters.get(
                    "shuffle_records", 0))
            return part

    # --- the mesh waves ---------------------------------------------------- #

    def _fit_mesh_scale(self, need: list[int], bases: list[int]) -> int:
        """Double the sticky capacity scale until every round's capacity
        (``bases[k]`` times the scale) holds its largest part over the
        ranks (``need[k]``).  Returns the doublings, each a
        ``wave.mesh.retry`` span: the reruns ``repro`` makes of a wave that
        overflowed, at most ``MAX_RETRIES``."""
        doubled = 0
        while any(n > self._mesh_scale * b for n, b in zip(need, bases)):
            if doubled >= self.MAX_RETRIES:
                raise RuntimeError("wave shuffle overflow persisted at capacity "
                                   f"scale {self._mesh_scale}")
            doubled += 1
            self._mesh_scale *= 2
            with obs_trace.span("wave.mesh.retry") as sp:
                if sp:
                    sp.set(retry=doubled, scale=self._mesh_scale)
        return doubled

    def _mesh_rows(self, rounds) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's kept rows of a mesh wave (unsorted): the direct
        candidates, or on the stats route each round's reducer output
        materialized and frozen (``segment_from_wave_stats``)."""
        if self._direct:
            return self._candidate_rows([(f, c, lanes)
                                         for (_, f, c), lanes in rounds])
        from repro_torch.index.build import segment_from_wave_stats
        stats = None
        for dense, _ in rounds:
            part = materialize(dense, 1)
            stats = part if stats is None else stats.merged_with(part)
        seg = segment_from_wave_stats(stats, vocab_size=self.cfg.vocab_size,
                                      device=self.device)
        return seg.keys, seg.counts

    def _mesh_counters(self, cnt: np.ndarray, hist, rec_bytes: int,
                       retries: int) -> dict:
        """A mesh wave's counters from its reduced ``[rounds, 3]`` block
        (map records, shuffled records, overflow) and, when measured, its
        reduced skew histograms ``[rounds, _SKEW_BUCKETS]``."""
        from repro_torch.core.stats import add_counters
        counters: dict = {}
        if retries:
            add_counters(counters, retries=retries)
        for k in range(cnt.shape[0]):
            shuf = int(cnt[k, 1])
            add_counters(counters, jobs=1, map_records=int(cnt[k, 0]),
                         shuffle_records=shuf, shuffle_bytes=shuf * rec_bytes)
            if hist is not None and shuf:
                skew = float(hist[k].max() * _SKEW_BUCKETS / max(hist[k].sum(), 1))
                counters["shuffle_skew"] = max(counters.get("shuffle_skew", 0.0),
                                               skew)
        return counters

    def _submit_wave_mesh(self, slab: torch.Tensor, n_live: int, *,
                          gather: bool = False) -> dict:
        """Run one mesh wave's round chain on this rank, with every
        collective the wave needs, in one fixed order: the halo, the
        capacity fit, the exchange, one reduction of the counters (and one
        of the skew histograms when measured), and with ``gather`` the
        gather of every rank's kept rows (the streaming ingest's).

        The window ``slab`` [wave + sigma - 1] splits as ``[P, n_local]``
        with ``n_local = max(ceil(len / P), sigma - 1, 1)``; this rank emits
        over its row and a sigma - 1 halo from the next rank (zeros on the
        last), with ``clip(n_live - rank * n_local, 0, n_local)`` live
        positions.  Each round emits, combines, keys and partitions
        (``hash_partition``) its records; at ``tau_eff = 1`` a round's carry
        is a function of the rank's own window and emits, so every round
        partitions before any exchange.  One reduction then fits all the
        rounds' capacities (the scale times ``max(8, int(capacity_factor *
        emit rows / P) + 1)`` each), and one all-to-all moves every round's
        buckets; each round then sorts and reduces what it received.
        """
        from repro_torch.core.common import halo as halo_of
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        n_parts, halo = mesh.size, cfg.sigma - 1
        lane_vocab = plan.effective_lane_vocab(cfg)
        n_l = packing.n_lanes(cfg.sigma, lane_vocab)
        combine_route = plan.combine.route if plan.combine is not None else None
        rec_bytes = packing.record_bytes(cfg.sigma, lane_vocab, n_meta=plan.map.n_meta)
        win_len = int(slab.shape[0])
        n_local = max(-(-win_len // n_parts), halo, 1)
        lo = min(mesh.rank * n_local, win_len)
        own = slab[lo:lo + n_local]
        with obs_trace.span("wave.mesh.dispatch") as sp:
            if sp:
                sp.set(n_live=n_live, rounds=plan.rounds, n_local=n_local,
                       scale=self._mesh_scale)
            tok = torch.zeros((n_local,), dtype=torch.int32, device=self.device)
            tok[:own.shape[0]].copy_(own, non_blocking=True)
            tok_ext = torch.cat([tok, halo_of(tok[:halo], mesh)]) if halo else tok
            n_live_local = min(max(n_live - mesh.rank * n_local, 0), n_local)
            parts, hists = [], []
            carry = None
            for k in range(1, plan.rounds + 1):
                records, valid, emit_extras = plan.map.emit(
                    tok_ext, None, n_live_local, cfg, carry, k)
                base = max(8, int(cfg.capacity_factor * records.shape[0]
                                  / n_parts) + 1)
                map_rec = valid.sum()
                del valid
                if combine_route is not None:
                    records = stages.combine(records, n_l, False,
                                             route=combine_route)
                live = records[:, n_l] > 0
                key = stages.partition_keys(records, n_l, kind=plan.shuffle.key,
                                            vocab_size=lane_vocab)
                if self._with_skew:
                    hists.append(kops.hash_partition(key, live,
                                                     n_parts=_SKEW_BUCKETS)[1])
                part, hist = kops.hash_partition(key, live, n_parts=n_parts)
                parts.append((records, part, hist, map_rec, base))
                del key, live
                if k < plan.rounds and plan.update_carry is not None:
                    carry = plan.update_carry(cfg, 1, k, tok_ext, None, {},
                                              emit_extras, carry)
                del emit_extras
            del carry
            need = mesh.all_reduce(torch.stack([h.max() for _, _, h, _, _ in parts]),
                                   "max").tolist()
            retries = self._fit_mesh_scale(need, [b for *_, b in parts])
            bufs, caps, overflow = [], [], []
            for records, part, hist, _, base in parts:
                caps.append(self._mesh_scale * base)
                buf, over = mr_shuffle.bucketize(records, part, n_parts, caps[-1],
                                                 counts=hist)
                bufs.append(buf)
                overflow.append(over)
            recv = mesh.all_to_all(torch.cat(bufs, dim=1))   # [P, sum(caps), W]
            del bufs
            rounds, cnt_rows, off = [], [], 0
            for (_, _, _, map_rec, _), cap, over in zip(parts, caps, overflow):
                local = recv[:, off:off + cap].reshape(-1, recv.shape[-1])
                off += cap
                cnt_rows.append(torch.stack([map_rec.to(torch.int64),
                                             (local[:, n_l] > 0).sum(), over]))
                rec = stages.sort_stage(local, n_keys=n_l)
                del local
                if plan.reduce.kind == "suffix":
                    dense = stages.reduce_suffix(rec, sigma=cfg.sigma,
                                                 vocab_size=lane_vocab)
                else:
                    # position payloads feed only the tau > 1 carries
                    dense = stages.reduce_exact(rec, sigma=cfg.sigma,
                                                vocab_size=lane_vocab)
                rounds.append((dense[:3], rec[:, :n_l]))
                del rec, dense
            del parts, recv
            cnt = mesh.all_reduce(torch.stack(cnt_rows)).cpu().numpy()
            hist = (mesh.all_reduce(torch.stack(hists)).cpu().numpy()
                    if self._with_skew else None)
            if int(cnt[:, 2].sum()):
                raise RuntimeError("a fitted wave exchange overflowed")
            counters = self._mesh_counters(cnt, hist, rec_bytes, retries)
            pend = {"mesh": True, "rounds": rounds, "counters": counters,
                    "slab": slab}
            if gather:
                keys, cnts = self._mesh_rows(rounds)
                pend["rows"] = torch.cat(mesh.all_gather_rows(
                    torch.cat([keys, cnts[:, None]], dim=1)))
                pend["rounds"] = []
                del keys, cnts
            del rounds
            pend["done"] = self._wave_event(tok)
            return pend

    def _collect_wave_segment_mesh(self, pend: dict) -> WavePartial:
        """A mesh wave's sorted segment: this rank's kept rows, or with the
        gather every rank's (the rank sets are disjoint, since the exchange
        sends all evidence of a gram to one rank), sorted on this rank."""
        with obs_trace.span("wave.mesh.collect") as sp:
            self._await(pend)
            counters = pend["counters"]
            if "rows" in pend:
                rows = pend.pop("rows")
                keys, cnts = rows[:, :-1], rows[:, -1]
            else:
                keys, cnts = self._mesh_rows(pend["rounds"])
            part = self._sorted_partial(keys, cnts, counters)
            del keys, cnts
            if sp:
                sp.set(rows=part.n_rows, retries=counters.get("retries", 0),
                       shuffle_records=counters.get("shuffle_records", 0))
            return part

    def _collect_wave_mesh(self, pend: dict):
        """A gathered mesh wave -> ``NGramStats`` (``iter_wave_stats``)."""
        from repro_torch.index.merge import segment_to_stats
        part = self._collect_wave_segment_mesh(pend)
        out = segment_to_stats(part.segment)
        out.counters = dict(part.counters)
        return out

    def _gather_segment(self, seg, min_count: int):
        """Every rank's rows of its folded segment with cf >= ``min_count``,
        merged into segment order on every rank (the parts are disjoint)."""
        from repro_torch.index import merge
        from repro_torch.index.build import IndexSegment
        r = seg.n_rows
        keys, cnts = seg.keys[:r], seg.counts[:r]
        if min_count > 1:
            keep = cnts >= min_count
            keys, cnts = keys[keep], cnts[keep]
        parts = [IndexSegment(keys=p[:, :-1], counts=p[:, -1], sigma=seg.sigma,
                              vocab_size=seg.vocab_size)
                 for p in self.mesh.all_gather_rows(
                     torch.cat([keys, cnts[:, None]], dim=1))
                 if p.shape[0]]
        if len(parts) > 1:
            return merge.merge_segments(parts, route=self.merge_route)
        return parts[0] if parts else IndexSegment(
            keys=keys[:0], counts=cnts[:0], sigma=seg.sigma,
            vocab_size=seg.vocab_size)

    # --- public iteration -------------------------------------------------- #

    def _submit_gathered(self, tok_ext, n_live: int, slab=None) -> dict:
        """:meth:`_submit_wave`, with a mesh wave's rows gathered to every
        rank (the per-wave outputs of ``iter_wave_stats`` and
        ``run_streaming``)."""
        if self._use_mesh:
            return self._submit_wave_mesh(slab, n_live, gather=True)
        return self._submit_wave(tok_ext, n_live, slab)

    def _start(self, tokens) -> np.ndarray:
        """The corpus on the host, checked; on a mesh, whether this run
        measures the skew (some rank has a metrics registry: one reduction,
        so that every rank runs the same collectives)."""
        tokens = _host_tokens(tokens)
        self.cfg.validate_tokens(tokens)
        if self._use_mesh:
            self._with_skew = bool(self.mesh.max_int(
                int(bool(obs_metrics.get_registry()))))
        return tokens

    def iter_wave_stats(self, tokens):
        """Per-wave exact partials (``tau = 1``), double-buffered: wave i + 1
        is enqueued before wave i is materialized.  On a mesh every rank
        gets every wave's whole partial."""
        tokens = self._start(tokens)
        drv = DoubleBufferedDriver(self._submit_gathered, collect=self._collect_wave)
        for slab, tok_ext, n_live in self._windows(tokens,
                                                   to_device=not self._use_mesh):
            res, _ = drv.submit(tok_ext, n_live, slab)
            if res is not None:
                yield res
        res, _ = drv.drain()
        if res is not None:
            yield res

    def _for_each_wave(self, tokens, consume, *, collect=None, submit=None,
                       fold_calls: _FoldCollectives | None = None) -> None:
        """Run ``consume(collect(submit(wave)))`` for every wave, in wave
        order.

        The calling thread only pads, copies and enqueues waves; a fold
        thread collects each one and runs ``consume`` (the accumulator push
        of :meth:`run`, the generational ingest of :meth:`run_streaming`),
        so the fold's host work and syncs overlap the next waves' device
        work.  On the card the fold thread works on a stream of its own that
        waits for each wave's event.  A queue of ``_WAVES_IN_FLIGHT`` bounds
        the waves in flight; one FIFO fold thread keeps wave order, so the
        fold sequence is the serial one.  ``overlap=False`` serializes.
        ``fold_calls``: the fold thread's collectives, which this thread
        serves (see :class:`_FoldCollectives`).
        """
        collect = collect or self._collect_wave
        submit = submit or self._submit_wave
        tokens = self._start(tokens)
        windows = self._windows(tokens, to_device=not self._use_mesh)
        if not self.overlap:
            for slab, tok_ext, n_live in windows:
                consume(collect(submit(tok_ext, n_live, slab)))
            return
        work: queue.Queue = queue.Queue(maxsize=_WAVES_IN_FLIGHT)
        failure: list[BaseException] = []
        side = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                else None)

        def fold_loop():
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                while True:
                    pend = work.get()
                    try:
                        if pend is None:
                            return
                        if not failure:
                            consume(collect(pend))
                    except BaseException as e:      # re-raised by the feeder
                        failure.append(e)
                    finally:
                        if pend is not None and fold_calls is not None:
                            fold_calls.wave_done()
                        del pend                    # free the wave's tensors
                        work.task_done()

        folder = threading.Thread(target=fold_loop, name="wave-fold",
                                  daemon=True)
        folder.start()
        submitted = served = 0
        try:
            for slab, tok_ext, n_live in windows:
                if failure:
                    break
                if fold_calls is not None and submitted - served >= 2:
                    fold_calls.serve()
                    served += 1
                work.put(submit(tok_ext, n_live, slab))
                submitted += 1
            while fold_calls is not None and served < submitted:
                fold_calls.serve()
                served += 1
        except BaseException as e:
            if fold_calls is not None:
                fold_calls.close(e)
            raise
        finally:
            work.put(None)
            folder.join()
        if side is not None:
            # what the fold made is read on the caller's stream from here on
            torch.cuda.current_stream(self.device).wait_stream(side)
        if failure:
            raise failure[0]

    # --- whole-job execution ----------------------------------------------- #

    def _accumulator(self):
        """The fold of :meth:`run`, and the collectives its fold thread
        needs (on a mesh, the tiered accumulator's rung sizes)."""
        from repro_torch.index import merge
        if self.accumulator != "tiered":
            cls = {"defer": merge.DeferredSegmentAccumulator,
                   "pairwise": merge.PairwiseSegmentAccumulator}[self.accumulator]
            return cls(route=self.merge_route), None
        calls = global_rows = None
        if self._use_mesh:
            if self.overlap:
                calls = _FoldCollectives(self.mesh)
                global_rows = calls.sum_int
            else:
                global_rows = lambda rows: self.mesh.sum_ints(rows)[0]  # noqa: E731
        return merge.TieredSegmentAccumulator(route=self.merge_route,
                                              global_rows=global_rows), calls

    def run(self, tokens):
        """Run the job over waves -> ``NGramStats`` in canonical order, equal
        to the monolithic job's.  ``fold_rows`` in the counters is the rows
        the accumulator fed through ``merge_segments`` (on a mesh, summed
        over the ranks' folds)."""
        from repro_torch.core.stats import NGramStats
        from repro_torch.index import merge

        with obs_trace.span("wave.run") as root:
            tokens = _host_tokens(tokens)
            if root:
                root.set(n_tokens=int(tokens.shape[0]), method=self.cfg.method,
                         accumulator=self.accumulator)
            counters = dict.fromkeys(
                ("jobs", "map_records", "shuffle_records", "shuffle_bytes",
                 "retries", "overflow", "waves", "fold_rows"), 0)
            counters["shuffle_skew"] = 0.0
            acc, fold_calls = self._accumulator()

            def fold(part: WavePartial):
                counters["waves"] += 1
                obs_metrics.merge_counter_dicts(counters, part.counters)
                with obs_trace.span("wave.fold") as sp:
                    if sp:
                        sp.set(wave=counters["waves"] - 1, rows=part.n_rows)
                    acc.push(part.segment, n_rows=part.n_rows)

            self._for_each_wave(tokens, fold, collect=self._collect_wave_segment,
                                fold_calls=fold_calls)
            with obs_trace.span("wave.finalize") as sp:
                # tau filters before the term unpack: only survivors pay it
                if self._use_mesh:
                    out = merge.segment_to_stats(
                        self._gather_segment(acc.result(), self.cfg.tau))
                    (counters["fold_rows"],) = self.mesh.sum_ints(acc.fold_rows)
                else:
                    out = merge.segment_to_stats(acc.result(),
                                                 min_count=self.cfg.tau)
                    counters["fold_rows"] = acc.fold_rows
                out = NGramStats(out.grams, out.lengths, out.counts,
                                 obs_metrics.normalize_counters(counters))
                if sp:
                    sp.set(rows=len(out), fold_rows=counters["fold_rows"])
            return out

    def run_streaming(self, tokens, *, gen=None, compress: bool = False,
                      block_size: int = 4, **gen_kw):
        """Stream waves straight into a :class:`GenerationalIndex`: each
        wave's exact partial is ingested as a fresh L0 segment on the fold
        thread, so point and top-k answers equal a from-scratch build over
        the whole corpus at ``tau = 1``.  On a mesh each wave's rows are
        gathered to every rank first, so every rank's index and reports
        equal the single-device run's.  Returns ``(index, reports)``, one
        ingest report a wave."""
        from repro_torch.index.merge import GenerationalIndex
        if gen is None:
            gen = GenerationalIndex(sigma=self.cfg.sigma,
                                    vocab_size=self.cfg.vocab_size,
                                    compress=compress, block_size=block_size,
                                    device=self.device, **gen_kw)
        reports = []

        def ingest(part: WavePartial):
            # an empty wave ingests no segment
            reports.append(gen.ingest_segment(
                part.segment if part.n_rows else None, n_rows=part.n_rows))

        self._for_each_wave(tokens, ingest, collect=self._collect_wave_segment,
                            submit=self._submit_gathered)
        return gen, reports
