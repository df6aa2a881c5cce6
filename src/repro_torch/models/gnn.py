"""GIN (Xu et al., arXiv:1810.00826): h' = MLP((1 + eps) h + sum_{j in N(i)} h_j)
(port of ``repro.models.gnn``).

Message passing is a gather of the source rows and an ``index_add_`` into
the destination rows, ``repro``'s ``jnp.take`` and ``segment_sum``.  One
autograd function (:class:`_Propagate`) does both, over bounded chunks of
edges, and keeps no ``[E, F]`` tensor for its backward, which is the same
pair of ops the other way round (gather the destinations' gradient, add it
into the sources).  The gather reads ``h`` rounded to ``cfg.comm_dtype``
and accumulates in ``cfg.dtype``, as ``repro``'s; its backward rounds each
edge's gradient to ``comm_dtype`` as ``repro``'s transpose of the cast
does, but sums those in float64 and rounds the sum once, where XLA sums in
``comm_dtype``: so the card and the CPU agree, whatever order the card's
atomic adds take.

:func:`loss_fn_dst_partitioned` is ``repro``'s ``shard_map`` message
passing on a :class:`~repro_torch.launch.mesh.DataMesh`: every rank takes
the same global batch and its own range of nodes and edges; each layer does
one all-gather of ``h`` in ``comm_dtype`` (its backward a reduce-scatter
in float32), then a local ``index_add_``.  Its gradient in the replicated
parameters is all-reduced in the backward, so ``torch.autograd.grad`` gives every rank
the gradient of the global loss, which ``jax.grad`` takes through
``repro``'s ``shard_map``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.launch.mesh import Replicated, SumOverRanks
from repro_torch.training.tree import TreeModule, map_leaves, tree_to_numpy

# edges a chunk of message passing gathers at once: its [chunk, F] float32
# temporaries stay near a GiB at F = 100
EDGE_CHUNK = 1 << 21


@dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 16
    learnable_eps: bool = True
    dtype: Any = torch.float32
    # dtype of node features on the wire: with nodes sharded over the ranks,
    # every layer all-gathers h for the source-side gather; bf16 halves those
    # bytes.  Aggregation still accumulates in ``dtype`` after the gather.
    comm_dtype: Any = torch.float32


class GIN(TreeModule):
    def forward(self, batch):
        return forward(self.tree(), batch["features"], batch["edge_src"],
                       batch["edge_dst"], batch.get("edge_mask"),
                       batch["features"].shape[0], self.cfg)


def init_params(cfg: GINConfig, device=None, generator=None) -> GIN:
    """A model with ``repro``'s parameter shapes and scales, drawn from
    ``generator`` (seed 0 on the device if none is given) on the device:
    the card unless ``device`` says otherwise.  ``eps`` is float32 whatever
    ``cfg.dtype`` is."""
    dev = resolve_device(device)
    g = generator
    if g is None and dev.type != "meta":
        g = torch.Generator(dev).manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=g, dtype=cfg.dtype, device=dev)

    layers = []
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        layers.append({
            "w1": normal((d_in, cfg.d_hidden)).mul_(d_in ** -0.5),
            "b1": torch.zeros(cfg.d_hidden, dtype=cfg.dtype, device=dev),
            "w2": normal((cfg.d_hidden, cfg.d_hidden)).mul_(cfg.d_hidden ** -0.5),
            "b2": torch.zeros(cfg.d_hidden, dtype=cfg.dtype, device=dev),
            "eps": torch.zeros((), dtype=torch.float32, device=dev),
        })
        d_in = cfg.d_hidden
    return GIN(cfg, {"layers": layers,
                     "head": normal((cfg.d_hidden, cfg.n_classes))
                     .mul_(cfg.d_hidden ** -0.5)})


def param_tree(model: GIN) -> dict:
    """The model's parameters (the tensors themselves) in ``repro``'s tree:
    ``layers/<l>/{w1,b1,w2,b2,eps}`` and ``head``."""
    return model.tree()


def params_from_numpy(tree: dict, cfg: GINConfig, device=None) -> GIN:
    """``repro``'s parameter pytree as numpy arrays -> the port's model on
    ``device`` (the card unless told otherwise); ``eps`` stays float32."""
    dev = resolve_device(device)

    def tensor(a, dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    layers = [{k: tensor(v, torch.float32 if k == "eps" else cfg.dtype)
               for k, v in pl.items()} for pl in tree["layers"]]
    return GIN(cfg, {"layers": layers, "head": tensor(tree["head"], cfg.dtype)})


def params_to_numpy(model: GIN) -> dict:
    """The inverse of :func:`params_from_numpy`: float32 numpy arrays."""
    return tree_to_numpy(model.tree())


# ------------------------------------------------------------ message passing
def _scatter_rows(h, src, dst, w, n_out, dtype):
    """sum over edges e of w[e] * h[src[e]] (cast to ``dtype``), added into
    row dst[e] of an [n_out, F] ``dtype`` tensor; chunks of edges."""
    out = torch.zeros((n_out, h.shape[1]), dtype=dtype, device=h.device)
    for lo in range(0, src.shape[0], EDGE_CHUNK):
        msg = h.index_select(0, src[lo:lo + EDGE_CHUNK]).to(dtype)
        if w is not None:
            msg.mul_(w[lo:lo + EDGE_CHUNK, None])
        out.index_add_(0, dst[lo:lo + EDGE_CHUNK], msg)
    return out


def _gather_grad(g_agg, src, dst, w, n_in, comm_dtype):
    """The transpose of :func:`_scatter_rows` (its ``src`` and ``dst``
    swapped), each edge's term rounded to ``comm_dtype``, summed in float64
    and rounded to float32 [n_in, F].

    float64, because a hub's row sums millions of edges (a skewed graph's
    source ids): in float32 the order of the card's atomic adds moves such
    a sum, and the rounding to ``comm_dtype`` after it can flip, by 1e-3 of
    a gradient leaf at ogbn-products' size between two runs on one card; in
    float64 the float32 result no longer depends on the order."""
    g_h = torch.zeros((n_in, g_agg.shape[1]), dtype=torch.float64, device=g_agg.device)
    for lo in range(0, src.shape[0], EDGE_CHUNK):
        g = g_agg.index_select(0, dst[lo:lo + EDGE_CHUNK])
        if w is not None:
            g = g * w[lo:lo + EDGE_CHUNK, None]
        g_h.index_add_(0, src[lo:lo + EDGE_CHUNK], g.to(comm_dtype).double())
    return g_h.float()


class _Propagate(torch.autograd.Function):
    """agg[n_out, F] = sum over edges e of w[e] * h_comm[src[e]] (cast to
    ``dtype``), added into row dst[e]; h_comm is ``h`` rounded to
    ``comm_dtype``.  Backward: each edge's gradient rounded to
    ``comm_dtype``, the sum in float64, rounded once (:func:`_gather_grad`)."""

    @staticmethod
    def forward(ctx, h, src, dst, w, n_out, comm_dtype, dtype):
        ctx.save_for_backward(src, dst, w)
        ctx.meta = (h.shape[0], h.dtype, comm_dtype)
        return _scatter_rows(h.to(comm_dtype), src, dst, w, n_out, dtype)

    @staticmethod
    def backward(ctx, g_agg):
        src, dst, w = ctx.saved_tensors
        n_in, h_dtype, comm_dtype = ctx.meta
        g_h = _gather_grad(g_agg, src, dst, w, n_in, comm_dtype)
        return g_h.to(comm_dtype).to(h_dtype), None, None, None, None, None, None


def _edges(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _edge_weight(edge_mask, dtype, device):
    if edge_mask is None:
        return None
    return torch.as_tensor(edge_mask, device=device).to(dtype)


def _layer(pl, h, agg, dtype):
    z = (1.0 + pl["eps"]).to(dtype) * h + agg
    z = F.relu(torch.matmul(z, pl["w1"]) + pl["b1"])
    return F.relu(torch.matmul(z, pl["w2"]) + pl["b2"])


def forward(params, feats, edge_src, edge_dst, edge_mask, n_nodes: int,
            cfg: GINConfig):
    """feats [N, F]; edges (src -> dst); returns logits [N, C]."""
    dev = params["head"].device
    h = torch.as_tensor(feats, device=dev).to(cfg.dtype)
    src, dst = _edges(edge_src, dev), _edges(edge_dst, dev)
    w = _edge_weight(edge_mask, cfg.dtype, dev)
    for pl in params["layers"]:
        agg = _Propagate.apply(h, src, dst, w, n_nodes, cfg.comm_dtype, cfg.dtype)
        h = _layer(pl, h, agg, cfg.dtype)
    return torch.matmul(h, params["head"])


def _nll(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return logz - gold


def loss_fn(params, batch, cfg: GINConfig):
    """batch: features, edge_src, edge_dst, edge_mask, labels, label_mask
    (both masks optional)."""
    feats = batch["features"]
    logits = forward(params, feats, batch["edge_src"], batch["edge_dst"],
                     batch.get("edge_mask"), feats.shape[0], cfg)
    nll = _nll(logits, torch.as_tensor(batch["labels"], device=logits.device).long())
    mask = batch.get("label_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
        nll = torch.where(mask, nll, 0.0)
        denom = torch.clamp(mask.sum(), min=1)
    else:
        denom = nll.shape[0]
    loss = torch.sum(nll) / denom
    return loss, {"ce": loss}


# ------------------------------------------------------------- across ranks
def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` [n, ...] as its raw bytes [n, k] (uint8): a gather of rows then
    takes any dtype on any backend."""
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)


class _GatherPropagate(torch.autograd.Function):
    """:class:`_Propagate` over every rank's rows: this rank's ``h``
    [n_local, F] rounded to ``comm_dtype`` and all-gathered, then its own
    edges (global ``src``, local ``dst``) scattered into [n_local, F].

    Backward: the gradient of the gathered rows (:func:`_gather_grad`, in
    float32), reduce-scattered in float32 and rounded to ``comm_dtype``
    once, so that it is the one-device gradient but for float32 rounding:
    a reduce-scatter in ``comm_dtype`` would round each rank's partial sum
    first, 1e-3 of a gradient leaf away on 4 ranks at 64 nodes."""

    @staticmethod
    def forward(ctx, h, src, dst, w, comm_dtype, dtype, mesh):
        ctx.save_for_backward(src, dst, w)
        ctx.meta = (h.shape[0], h.dtype, comm_dtype, mesh)
        hc = h.to(comm_dtype)
        rows = mesh.all_gather(_bytes(hc)).reshape(-1).view(comm_dtype)
        hg = rows.reshape(mesh.size * h.shape[0], h.shape[1])
        return _scatter_rows(hg, src, dst, w, h.shape[0], dtype)

    @staticmethod
    def backward(ctx, g_agg):
        src, dst, w = ctx.saved_tensors
        n_local, h_dtype, comm_dtype, mesh = ctx.meta
        g_hg = _gather_grad(g_agg, src, dst, w, mesh.size * n_local, comm_dtype)
        g_h = mesh.reduce_scatter(g_hg)
        return g_h.to(comm_dtype).to(h_dtype), None, None, None, None, None, None


def loss_fn_dst_partitioned(params, batch, cfg: GINConfig, mesh):
    """Distributed message passing with dst-partitioned edges.

    Contract (``repro``'s): nodes are range-sharded over the ranks and the
    edge arrays are partitioned so each rank's edges target only its own
    dst range (``data.graph.partition_edges_by_dst``); node and edge counts
    divide by ``mesh.size``.  Every rank passes the same global batch and
    gets the global loss; the scatter is local and the only communication
    is one all-gather of the (``comm_dtype``) node features a layer.
    """
    dev = params["head"].device
    p, r = mesh.size, mesh.rank
    n = batch["features"].shape[0] // p
    e = batch["edge_src"].shape[0] // p

    def local(key, rows):
        return torch.as_tensor(batch[key], device=dev)[r * rows:(r + 1) * rows]

    params = map_leaves(lambda t: Replicated.apply(t, mesh), params)
    h = local("features", n).to(cfg.dtype)
    src = local("edge_src", e).long()
    dst = local("edge_dst", e).long() - r * n
    w = local("edge_mask", e).to(cfg.dtype)
    for pl in params["layers"]:
        agg = _GatherPropagate.apply(h, src, dst, w, cfg.comm_dtype, cfg.dtype, mesh)
        h = _layer(pl, h, agg, cfg.dtype)
    nll = _nll(torch.matmul(h, params["head"]), local("labels", n).long())
    lmask = local("label_mask", n)
    count = mesh.all_reduce(lmask.sum().reshape(1))[0]
    part = torch.where(lmask, nll, 0.0).sum() / torch.clamp(count, min=1)
    loss = SumOverRanks.apply(part.reshape(1), mesh)[0]
    return loss, {"ce": loss}
