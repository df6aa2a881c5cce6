"""The dry run's regions (``launch.dryrun``): the layouts that ``repro``'s
GSPMD and ``shard_map`` give its model functions on a production mesh,
written once for DTensors, in this one module.

A model function marked :func:`~repro_torch.launch.mesh.has_region` runs
as it is unless :func:`installed` holds (``launch.dryrun`` enters it around
every trace).  Then the call goes to the region below that is installed
for it, which is handed the plain function: on DTensor arguments the region
runs it on each device's local shards (:func:`~repro_torch.launch.mesh.
shard_map`), with the collectives the layout needs over the ``DeviceMesh``
axes; on plain tensors (a region's own local code calls marked functions
too) it calls the plain function unchanged.  So the model modules hold one
path, the real program's, and no test of DTensors.

The regions, by the function they stand in for:

  * attention (``layers.gqa_attention``): each device's batch rows and
    query heads; K/V split over the heads alike where their heads divide,
    else whole, each device taking its query heads' share;
  * decode attention: the same, plus cache slots split over axes (context
    parallel), which combine their partial softmax sums over those axes;
  * SwiGLU: the Megatron layout, the hidden width split as ``w_gate`` is,
    the output summed over that width's axes;
  * a cross-entropy chunk and the decode logits: vocab-parallel, each
    device's slice of the vocabulary;
  * lookups in row-sharded tables (the LM embedding, the recsys tables):
    ids outside a device's rows read zeros, the rows summed over the
    table's axes;
  * the two-tower in-batch softmax: each device's users against every
    item;
  * ``repro``'s ``shard_map`` regions: the sharded MoE on a
    ``DeviceGrid`` and GIN's dst-partitioned loss;
  * the sharding constraints (``transformer.constrain`` and
    ``split_heads``), which place an activation and compute nothing;
  * the train step's glue: a gradient placed as its parameter (the
    reduce-scatter or all-reduce of a partial sum, as XLA's), each
    device's own rows as a microbatch, and AdamW's pieces cut from each
    device's local shards, as the real update cuts a tensor.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.launch.mesh import (_REGIONS, P, SumOverRanks, axes_rank, is_dtensor,
                                     mesh_axes, placements, shard_map, spec_entry,
                                     split_axes)
from repro_torch.models import gnn, layers, moe, recsys, transformer
from repro_torch.training import optimizer, train_loop

__all__ = ["installed", "sharded_lookup"]


@contextlib.contextmanager
def installed():
    """Every region below installed for the marked function it stands in
    for, for as long as this context lasts (nested contexts are fine)."""
    before = dict(_REGIONS)
    _REGIONS.update({
        layers.gqa_attention: _attention,
        layers.decode_attention: _decode,
        layers.swiglu: _swiglu,
        layers._chunk_nll: _chunk_nll,
        layers.lookup_rows: _rows,
        layers.head_logits: _head_logits,
        transformer.constrain: _constrain,
        transformer.split_heads: _split_heads,
        transformer.write_slot: _write_slot,
        moe.moe_ffn_sharded: _moe_sharded,
        gnn.loss_fn_dst_partitioned: _dst_partitioned,
        recsys.embedding_lookup: _rows,
        recsys._per_field: _per_field,
        recsys._in_batch_softmax: _in_batch_softmax,
        optimizer._pieces: _pieces,
        optimizer._copy_pieces: _copy_pieces,
        train_loop._placed_as: _placed_as,
        train_loop._microbatch: _microbatch,
    })
    try:
        yield
    finally:
        _REGIONS.clear()
        _REGIONS.update(before)


# ------------------------------------------------------------------ attention
def _kv_share(k: torch.Tensor, g: int, part: int, heads: int) -> torch.Tensor:
    """The K/V heads [B, T, KV, d] repeated for query heads ``part * heads``
    to ``(part + 1) * heads`` (``g`` query heads a kv head): the kv heads
    they read sliced first, then repeated."""
    lo, hi = part * heads, (part + 1) * heads
    k_lo, k_hi = lo // g, (hi - 1) // g + 1
    return layers._repeat_kv(k[:, :, k_lo:k_hi], g)[:, :, lo - k_lo * g:hi - k_lo * g]


def _attention(fn, q, k, v, *, q_positions, k_positions, window=None, q_chunk=0):
    """A region on each device's batch rows and query heads, as q lies (its
    heads split where the heads divide the axis).  K/V split over the heads
    alike when their heads divide too; else whole, each device taking its
    query heads' share (their gradient then a sum over those axes)."""
    if not is_dtensor(q):
        return fn(q, k, v, q_positions=q_positions, k_positions=k_positions,
                  window=window, q_chunk=q_chunk)
    mesh = q.device_mesh
    b_ax, h_ax = split_axes(q, 0), split_axes(q, 2)
    n_h = math.prod(mesh.shape[mesh.mesh_dim_names.index(a)] for a in h_ax)
    kv_split = k.shape[2] % n_h == 0 and (k.shape[2] // n_h) * (q.shape[2] // k.shape[2]) \
        == q.shape[2] // n_h
    qs = P(spec_entry(b_ax), None, spec_entry(h_ax), None)
    kvs = qs if kv_split else P(spec_entry(b_ax), None, None, None)
    g = q.shape[2] // k.shape[2]
    lo = axes_rank(mesh, h_ax)

    def local(ql, kl, vl):
        if not kv_split:
            kl = _kv_share(kl, g, lo, ql.shape[2])
            vl = _kv_share(vl, g, lo, ql.shape[2])
        return fn(ql, kl, vl, q_positions=q_positions, k_positions=k_positions,
                  window=window, q_chunk=q_chunk)
    partial = ((), () if kv_split else h_ax, () if kv_split else h_ax)
    return shard_map(local, mesh, (qs, kvs, kvs), qs, partial_axes=partial)(q, k, v)


def _decode(fn, q, k_cache, v_cache, *, valid):
    """A region on each device's batch rows, query heads and cache slots,
    as they lie.  K/V heads split like the queries' when they divide, else
    whole (each device taking its query heads' share); cache slots split
    over axes (context parallel) combine their partial softmax sums over
    those axes."""
    if not is_dtensor(q):
        return fn(q, k_cache, v_cache, valid=valid)
    mesh = q.device_mesh
    b_ax, h_ax = split_axes(q, 0), split_axes(q, 1)
    t_ax, kv_ax = split_axes(k_cache, 1), split_axes(k_cache, 2)
    g = q.shape[1] // k_cache.shape[2]
    h_lo, t_lo = axes_rank(mesh, h_ax), axes_rank(mesh, t_ax)
    slots = mesh_axes(mesh, t_ax) if t_ax else None
    kv_split = kv_ax == h_ax and bool(h_ax)

    def local(ql, kl, vl):
        if not kv_split:
            kl = _kv_share(kl, g, h_lo, ql.shape[1])
            vl = _kv_share(vl, g, h_lo, ql.shape[1])
        tl = kl.shape[1]
        live = valid[..., t_lo * tl:(t_lo + 1) * tl]
        if slots is None:
            return fn(ql, kl, vl, valid=live)
        kl = layers._repeat_kv(kl, ql.shape[1] // kl.shape[2])
        vl = layers._repeat_kv(vl, ql.shape[1] // vl.shape[2])
        scores = torch.einsum("bhd,bthd->bht", ql, kl).float() * ql.shape[2] ** -0.5
        scores = torch.where((live if live.dim() == 2 else live[None])[:, None], scores,
                             layers.NEG_INF)
        m = slots.all_reduce(scores.amax(-1), "max")
        p = torch.exp(scores - m[..., None])
        se = slots.all_reduce(p.sum(-1))
        o = slots.all_reduce(torch.einsum("bht,bthd->bhd", p.to(vl.dtype), vl).float())
        return (o / se[..., None]).to(vl.dtype)
    qs = P(spec_entry(b_ax), spec_entry(h_ax), None)
    cs = P(spec_entry(b_ax), spec_entry(t_ax), spec_entry(kv_ax), None)
    return shard_map(local, mesh, (qs, cs, cs), qs)(q, k_cache, v_cache)


# --------------------------------------------------------------- FFN and head
def _swiglu(fn, x, w_gate, w_up, w_down):
    """The Megatron layout GSPMD gives ``repro``'s: a region on each
    device's rows and its slice of the hidden width (as ``w_gate`` splits
    it, the weights gathered whole along ``d``), the output summed over
    that slice's axes."""
    if not is_dtensor(x):
        return fn(x, w_gate, w_up, w_down)
    mesh = x.device_mesh
    b_ax, f_ax = split_axes(x, 0), split_axes(w_gate, 1)
    sum_axes = mesh_axes(mesh, f_ax) if f_ax else None

    def local(xl, wg, wu, wo):
        y = fn(xl, wg, wu, wo)
        return SumOverRanks.apply(y, sum_axes) if sum_axes is not None else y
    xs = P(spec_entry(b_ax), *([None] * (x.dim() - 1)))
    return shard_map(local, mesh, (xs, P(None, spec_entry(f_ax)), P(None, spec_entry(f_ax)),
                                   P(spec_entry(f_ax), None)), xs,
                     partial_axes=(f_ax, b_ax, b_ax, b_ax))(x, w_gate, w_up, w_down)


def _chunk_nll(fn, x, lm_head, labels):
    """One chunk's summed cross entropy, vocab-parallel: a region on each
    device's rows and its slice of the vocabulary (as ``lm_head`` splits
    it), the log-sum-exp and the gold logits summed over the vocabulary's
    axes, the rows' sum over the batch axes.  GSPMD's layout of the same
    function."""
    if not is_dtensor(x):
        return fn(x, lm_head, labels)
    mesh = x.device_mesh
    b_ax, v_ax = split_axes(x, 0), split_axes(lm_head, 1)
    lo = axes_rank(mesh, v_ax)
    vocab_axes = mesh_axes(mesh, v_ax) if v_ax else None
    rows_axes = mesh_axes(mesh, b_ax) if b_ax else None

    def local(xl, wl, lab):
        logits = torch.matmul(xl, wl).float()
        off = lo * logits.shape[-1]
        m = logits.detach().amax(-1)
        if vocab_axes is not None:
            m = vocab_axes.all_reduce(m, "max")
        se = torch.exp(logits - m[..., None]).sum(-1)
        hit = (lab >= off) & (lab < off + logits.shape[-1])
        gold = torch.gather(logits, -1, (lab - off).clamp(0, logits.shape[-1] - 1)[..., None])
        gold = torch.where(hit, gold[..., 0], 0.0)
        if vocab_axes is not None:
            se = SumOverRanks.apply(se, vocab_axes)
            gold = SumOverRanks.apply(gold, vocab_axes)
        part = torch.sum(m + torch.log(se) - gold).reshape(1)
        return (SumOverRanks.apply(part, rows_axes) if rows_axes is not None else part)[0]
    return shard_map(local, mesh, (P(spec_entry(b_ax), None, None), P(None, spec_entry(v_ax)),
                                   P(spec_entry(b_ax), None)), P(),
                     partial_axes=(v_ax, b_ax, ()))(x, lm_head, labels)


def _head_logits(fn, x, head):
    """A region on each device's rows and its slice of the vocabulary (the
    weights gathered whole along ``d``): the logits stay split over the
    vocabulary."""
    if not is_dtensor(x):
        return fn(x, head)
    mesh = x.device_mesh
    b_ax, v_ax = split_axes(x, 0), split_axes(head, 1)
    return shard_map(fn, mesh, (P(spec_entry(b_ax), None), P(None, spec_entry(v_ax))),
                     P(spec_entry(b_ax), spec_entry(v_ax)),
                     partial_axes=(v_ax, b_ax))(x, head)


# -------------------------------------------------------------------- lookups
def sharded_lookup(lookup, table: torch.Tensor, ids: torch.Tensor, row_dim: int,
                   out_dims: int) -> torch.Tensor:
    """``lookup(table, ids)`` on DTensors: the vocab-parallel lookup GSPMD
    makes of ``repro``'s gather from a row-sharded table.  A region on each
    device's ids (as they lie) and rows of the table (its dimension
    ``row_dim`` as split): ids outside the device's rows read zeros, and
    the rows are summed over the table's axes."""
    mesh = table.device_mesh
    v_ax, b_ax = split_axes(table, row_dim), split_axes(ids, 0)
    part = axes_rank(mesh, v_ax)
    rows = mesh_axes(mesh, v_ax) if v_ax else None

    def local(tl, il):
        n = tl.shape[row_dim]
        il = il.long() - part * n
        hit = (il >= 0) & (il < n)
        out = lookup(tl, il.clamp(0, n - 1))
        out = out * hit.reshape(hit.shape + (1,) * (out.dim() - hit.dim())).to(out.dtype)
        return SumOverRanks.apply(out, rows) if rows is not None else out
    t_spec = P(*[spec_entry(v_ax) if d == row_dim else None for d in range(table.dim())])
    i_spec = P(spec_entry(b_ax), *([None] * (ids.dim() - 1)))
    return shard_map(local, mesh, (t_spec, i_spec),
                     P(spec_entry(b_ax), *([None] * (out_dims - 1))),
                     partial_axes=(b_ax, ()))(table, ids)


def _rows(fn, table, ids):
    """Rows of a [V, d] table (the LM embedding, a recsys table)."""
    if not is_dtensor(table):
        return fn(table, ids)
    return sharded_lookup(fn, table, ids, 0, ids.dim() + 1)


def _per_field(fn, tables, ids):
    if not is_dtensor(tables):
        return fn(tables, ids)
    return sharded_lookup(fn, tables, ids, 1, ids.dim() + tables.dim() - 2)


def _in_batch_softmax(fn, u, i, temp):
    """A region on each device's users against every item (gathered), each
    row's positive at its own index, the rows' sum over the batch axes."""
    if not is_dtensor(u):
        return fn(u, i, temp)
    mesh = u.device_mesh
    b_ax = split_axes(u, 0)
    part, rows = axes_rank(mesh, b_ax), (mesh_axes(mesh, b_ax) if b_ax else None)

    def local(ul, il):
        logits = torch.matmul(ul, il.T).float() / temp          # [B_local, B]
        r = torch.arange(ul.shape[0], device=ul.device)
        gold = logits[r, part * ul.shape[0] + r]
        total = torch.sum(torch.logsumexp(logits, dim=-1) - gold).reshape(1)
        return (SumOverRanks.apply(total, rows) if rows is not None else total)[0] / il.shape[0]
    return shard_map(local, mesh, (P(spec_entry(b_ax), None), P(None, None)), P(),
                     partial_axes=((), b_ax))(u, i)


# ------------------------------------------------------ sharding constraints
def _place(x: torch.Tensor, cfg, *tail) -> torch.Tensor:
    """A DTensor activation placed ``P(cfg.shard_activations, *tail)``."""
    mesh = x.device_mesh
    spec = P(cfg.shard_activations, *tail, *([None] * (x.dim() - 1 - len(tail))))
    return x.redistribute(mesh, placements(mesh, spec))


def _constrain(fn, x, cfg):
    """``repro``'s sharding constraint ``P(shard_activations, None, None)``."""
    if not is_dtensor(x) or cfg.shard_activations is None:
        return fn(x, cfg)
    return _place(x, cfg)


def _split_heads(fn, x, cfg, n_heads):
    """A projection ``[B, S, n_heads * d]`` with its heads over the
    ``model`` axis where they divide it (whole heads a device, as the
    weights' TP split gives them), else whole: the layout GSPMD reaches for
    the head reshape that follows."""
    if not is_dtensor(x):
        return fn(x, cfg, n_heads)
    names = x.device_mesh.mesh_dim_names
    tp = x.device_mesh.shape[names.index("model")] if "model" in names else 1
    return _place(x, cfg, None, "model" if tp > 1 and n_heads % tp == 0 else None)


def _write_slot(fn, cache, slot, value):
    """Each device writes its own shard of the cache: the value placed as
    the cache's rows, the slot written where the device's part of T holds
    it."""
    if not is_dtensor(cache):
        return fn(cache, slot, value)
    mesh = cache.device_mesh
    entries = [spec_entry(split_axes(cache, d)) for d in range(cache.dim())]
    local = cache.to_local()
    lo = axes_rank(mesh, split_axes(cache, 1)) * local.shape[1]
    if lo <= slot < lo + local.shape[1]:
        spec = P(entries[0], *entries[2:])
        local[:, slot - lo] = value.redistribute(mesh, placements(mesh, spec)).to_local()


# -------------------------------------------------- repro's shard_map regions
def _moe_sharded(fn, x, params: dict, cfg):
    """``moe_ffn_sharded`` over a dry run's ``DeviceGrid``: ``repro``'s
    ``shard_map`` specs (x over the batch axes, the router whole, the
    experts or their d_ff over ``model``, the shared experts' d_ff over
    ``model``), the region run on rank 0's shards."""
    if not is_dtensor(x):
        return fn(x, params, cfg)
    grid = cfg.mesh
    names = grid.data.names if grid.data is not None else ()
    dp = spec_entry(names)
    tp = cfg.tp_axis
    if moe.expert_parallel(cfg, grid.model.size):
        w = {"wg": P(tp, None, None), "wu": P(tp, None, None), "wo": P(tp, None, None)}
    else:
        w = {"wg": P(None, None, tp), "wu": P(None, None, tp), "wo": P(None, tp, None)}
    specs = {"router": P(), **w, "sg": P(None, tp), "su": P(None, tp), "so": P(tp, None)}
    keys = list(params)
    x_spec = P(dp, None, None)

    def local(xl, *vals):
        return fn(xl, dict(zip(keys, vals)), cfg)
    return shard_map(local, grid.mesh, (x_spec,) + tuple(specs[k] for k in keys),
                     (x_spec, P()))(x, *params.values())


def _dst_partitioned(fn, params, batch, cfg, mesh):
    """``repro``'s ``shard_map`` specs (``mesh`` a ``MeshAxes`` of the batch
    axes): the parameters whole, nodes and edges over the batch axes."""
    if not is_dtensor(batch["features"]):
        return fn(params, batch, cfg, mesh)
    from repro_torch.training.tree import like, tensors
    dp = spec_entry(mesh.names)
    leaves = tensors(params)

    def local(*vals):
        return gnn._dst_partitioned_local(like(params, list(vals[:len(leaves)])),
                                         *vals[len(leaves):], cfg=cfg, mesh=mesh)
    specs = (P(),) * len(leaves) + (P(dp, None),) + (P(dp),) * 5
    loss = shard_map(local, mesh.mesh, specs, P())(*leaves,
                                                   *(batch[k] for k in gnn._BATCH_KEYS))
    return loss, {"ce": loss}


# ------------------------------------------------------------ the train step
def _placed_as(fn, g, p):
    """A DTensor gradient in its parameter's placements: a partial sum over
    the batch axes reduce-scattered or all-reduced, as XLA's are."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return fn(g, p)


def _microbatch(fn, x, i, n):
    """On a DTensor whose rows are split over the batch axes, each device's
    own rows in ``n`` blocks (no row crosses a device, as ``repro``'s scan
    keeps its microbatches where the batch lies)."""
    if not is_dtensor(x) or not split_axes(x, 0):
        return fn(x, i, n)
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    part = fn(local, i, n)
    return DTensor.from_local(part, x.device_mesh, x.placements, run_check=False,
                              shape=torch.Size((x.shape[0] // n,) + tuple(x.shape[1:])),
                              stride=part.stride())


def _pieces(fn, columns, chunk):
    """AdamW's pieces cut from each device's local shards, as the real
    update cuts a tensor (``fn`` on the local tensors), each piece a
    DTensor replicated over the mesh: the update is elementwise, so every
    device updates its own shard and no collective runs."""
    if not is_dtensor(columns[0][0]):
        yield from fn(columns, chunk)
        return
    from torch.distributed.tensor import DTensor, Replicate
    mesh = columns[0][0].device_mesh
    whole = [Replicate()] * mesh.ndim
    for group in fn([[t.to_local() for t in col] for col in columns], chunk):
        yield [[DTensor.from_local(t, mesh, whole, run_check=False) for t in col]
               for col in group]


def _copy_pieces(fn, dst, src):
    """DTensor has no ``_foreach_copy_``: one ``copy_`` a piece."""
    if not is_dtensor(dst[0]):
        return fn(dst, src)
    for t, u in zip(dst, src):
        t.copy_(u)
