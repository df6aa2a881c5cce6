"""The four recsys architectures on a shared embedding substrate (port of
``repro.models.recsys``).

EmbeddingBag is a gather (``index_select``) and a segment reduce
(``index_add_`` for sum and mean, ``scatter_reduce_`` with ``amax`` for
max), as ``repro`` builds it from ``jnp.take`` and ``segment_sum`` /
``segment_max``: an empty bag is 0 under sum and mean and ``-inf`` under
max, where ``F.embedding_bag`` gives 0.

  bst        : Behavior Sequence Transformer (arXiv:1905.06874)
  autoint    : self-attention feature interaction (arXiv:1810.11921)
  two-tower  : sampled-softmax retrieval (YouTube, RecSys'19)
  xdeepfm    : Compressed Interaction Network + DNN (arXiv:1803.05170)

PyTorch form: one :class:`~repro_torch.training.tree.TreeModule` a model,
holding ``repro``'s parameter tree (``item_embed``, ``blocks/0/wq``,
``mlp/0/0``, ...).  The functions keep ``repro``'s names and take that tree
(:func:`param_tree`) with a batch of tensors, so
``training.train_loop.make_train_step`` drives ``bst_loss(params, batch,
cfg)`` as ``repro``'s drives its own (:func:`loss_fn` picks the arch's loss
by its config).  ``*_init(cfg, device, generator)`` (or :func:`init_params`)
draws the port's weights on the device (the card unless told otherwise);
:func:`params_from_numpy` carries ``repro``'s across.  An embedding
table's gradient is dense, as ``repro``'s is: AdamW then decays every row.
``repro``'s sharding of the tables over a TPU mesh is not ported: it
computes nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.launch.mesh import has_region
from repro_torch.training.tree import TreeModule, map_leaves, tree_to_numpy

from .layers import rms_norm


# ----------------------------------------------------------------- substrate
def _ids(ids: torch.Tensor, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device).long()


@has_region
def embedding_lookup(table: torch.Tensor, ids) -> torch.Tensor:
    """[V, D] table, integer ids [...]; out [..., D]."""
    ids = _ids(ids, table.device)
    return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[-1])


def embedding_bag(table: torch.Tensor, ids, segment_ids, num_segments: int,
                  mode: str = "sum") -> torch.Tensor:
    """Multi-hot bag reduce: gather rows, then reduce them by segment."""
    rows = embedding_lookup(table, ids)
    seg = _ids(segment_ids, table.device)
    if mode in ("sum", "mean"):
        s = rows.new_zeros((num_segments, rows.shape[-1])).index_add_(0, seg, rows)
        if mode == "sum":
            return s
        c = torch.zeros(num_segments, dtype=torch.float32,
                        device=table.device).index_add_(
            0, seg, torch.ones(seg.shape, dtype=torch.float32, device=table.device))
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        out = rows.new_full((num_segments, rows.shape[-1]), float("-inf"))
        return out.scatter_reduce_(0, seg[:, None].expand_as(rows), rows, "amax")
    raise ValueError(mode)


def mlp(x, layers, act=F.relu, final_act=False):
    for i, (w, b) in enumerate(layers):
        x = torch.matmul(x, w) + b
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def init_mlp(dims, dtype, normal):
    """``repro``'s layer shapes and scales, drawn by ``normal(shape, dtype)``."""
    out = []
    for a, b in zip(dims, dims[1:]):
        w = normal((a, b), dtype).mul_(a ** -0.5)
        out.append((w, torch.zeros(b, dtype=dtype, device=w.device)))
    return out


def bce_loss(logits, labels):
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@has_region
def _per_field(tables: torch.Tensor, ids) -> torch.Tensor:
    """Field ``f`` of ids [B, F] looked up in ``tables[f]`` ([F, V, ...]):
    [B, F, ...]."""
    ids = _ids(ids, tables.device)
    fields = torch.arange(ids.shape[1], device=tables.device)
    return tables[fields[None, :], ids]


def _drawer(device, generator):
    dev = resolve_device(device)
    g = generator
    if g is None and dev.type != "meta":      # meta tensors draw nothing
        g = torch.Generator(dev).manual_seed(0)

    def normal(shape, dtype):
        return torch.randn(shape, generator=g, dtype=dtype, device=dev)

    return dev, normal


# ------------------------------------------------------------------------ BST
@dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    item_vocab: int = 4_000_000
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp_dims: tuple = (1024, 512, 256)
    dtype: Any = torch.float32


class BST(TreeModule):
    def forward(self, batch):
        return bst_forward(self.tree(), batch, self.cfg)


def bst_init(cfg: BSTConfig, device=None, generator=None) -> BST:
    dev, normal = _drawer(device, generator)
    d, dt = cfg.embed_dim, cfg.dtype
    blocks = []
    for _ in range(cfg.n_blocks):
        blocks.append({
            "wq": normal((d, d), dt).mul_(d ** -0.5),
            "wk": normal((d, d), dt).mul_(d ** -0.5),
            "wv": normal((d, d), dt).mul_(d ** -0.5),
            "wo": normal((d, d), dt).mul_(d ** -0.5),
            "ff1": normal((d, 4 * d), dt).mul_(d ** -0.5),
            "ff2": normal((4 * d, d), dt).mul_((4 * d) ** -0.5),
            "ln1": torch.ones(d, dtype=dt, device=dev),
            "ln2": torch.ones(d, dtype=dt, device=dev),
        })
    flat_in = (cfg.seq_len + 1) * d
    return BST(cfg, {
        "item_embed": normal((cfg.item_vocab, d), dt).mul_(0.01),
        "pos_embed": normal((cfg.seq_len + 1, d), dt).mul_(0.01),
        "blocks": blocks,
        "mlp": init_mlp((flat_in,) + cfg.mlp_dims + (1,), dt, normal),
    })


def bst_forward(params, batch, cfg: BSTConfig):
    """Logits [B]; ``batch["labels"]`` is not read (it may be None)."""
    hist = embedding_lookup(params["item_embed"], batch["history"])   # [B, S, d]
    tgt = embedding_lookup(params["item_embed"], batch["target"])     # [B, d]
    x = torch.cat([hist, tgt[:, None]], dim=1) + params["pos_embed"][None]
    b, s, d = x.shape
    h_heads, dh = cfg.n_heads, d // cfg.n_heads
    for blk in params["blocks"]:
        hx = rms_norm(x, blk["ln1"])
        q = torch.matmul(hx, blk["wq"]).reshape(b, s, h_heads, dh)
        k = torch.matmul(hx, blk["wk"]).reshape(b, s, h_heads, dh)
        v = torch.matmul(hx, blk["wv"]).reshape(b, s, h_heads, dh)
        # the scores live only inside this line: at retrieval_cand's 1M rows
        # they are 14 GB
        p = torch.softmax(torch.einsum("bshd,bthd->bhst", q, k).float() * dh ** -0.5,
                          -1).to(x.dtype)
        o = torch.einsum("bhst,bthd->bshd", p, v).reshape(b, s, d)
        x = x + torch.matmul(o, blk["wo"])
        hx = rms_norm(x, blk["ln2"])
        x = x + torch.matmul(F.relu(torch.matmul(hx, blk["ff1"])), blk["ff2"])
    return mlp(x.reshape(b, s * d), params["mlp"])[:, 0]


def bst_loss(params, batch, cfg: BSTConfig):
    logits = bst_forward(params, batch, cfg)
    loss = bce_loss(logits, batch["labels"])
    return loss, {"bce": loss}


# -------------------------------------------------------------------- AutoInt
@dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    field_vocab: int = 1_000_000       # per-field vocab (Criteo-scale rows total)
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    n_dense: int = 13
    dtype: Any = torch.float32


class AutoInt(TreeModule):
    def forward(self, batch):
        return autoint_forward(self.tree(), batch, self.cfg)


def autoint_init(cfg: AutoIntConfig, device=None, generator=None) -> AutoInt:
    _, normal = _drawer(device, generator)
    dt = cfg.dtype
    layers = []
    d_in = cfg.embed_dim
    for _ in range(cfg.n_attn_layers):
        layers.append({k: normal((d_in, cfg.d_attn), dt).mul_(d_in ** -0.5)
                       for k in ("wq", "wk", "wv", "wres")})
        d_in = cfg.d_attn
    n_fields = cfg.n_sparse + 1                       # +1 dense-projection field
    return AutoInt(cfg, {
        "tables": normal((cfg.n_sparse, cfg.field_vocab, cfg.embed_dim), dt).mul_(0.01),
        "dense_proj": normal((cfg.n_dense, cfg.embed_dim), dt).mul_(cfg.n_dense ** -0.5),
        "layers": layers,
        "head": normal((n_fields * d_in, 1), dt).mul_((n_fields * d_in) ** -0.5),
    })


def autoint_forward(params, batch, cfg: AutoIntConfig):
    emb = _per_field(params["tables"], batch["sparse_ids"])     # [B, F, d]
    b = emb.shape[0]
    dense = torch.as_tensor(batch["dense"], device=emb.device)
    dense_f = torch.matmul(dense, params["dense_proj"])
    x = torch.cat([emb, dense_f[:, None]], dim=1)               # [B, F+1, d]
    for pl in params["layers"]:
        q = torch.matmul(x, pl["wq"])
        k = torch.matmul(x, pl["wk"])
        v = torch.matmul(x, pl["wv"])
        # scaled by the layer's input width: embed_dim at layer 0, then d_attn
        sc = torch.einsum("bfe,bge->bfg", q, k).float() * x.shape[-1] ** -0.5
        p = torch.softmax(sc, -1).to(x.dtype)
        x = F.relu(torch.einsum("bfg,bge->bfe", p, v) + torch.matmul(x, pl["wres"]))
    return torch.matmul(x.reshape(b, -1), params["head"])[:, 0]


def autoint_loss(params, batch, cfg: AutoIntConfig):
    loss = bce_loss(autoint_forward(params, batch, cfg), batch["labels"])
    return loss, {"bce": loss}


# ------------------------------------------------------------------ two-tower
@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    item_vocab: int = 10_000_000
    embed_dim: int = 256
    user_feat: int = 256
    tower_dims: tuple = (1024, 512, 256)
    dtype: Any = torch.float32


class TwoTower(TreeModule):
    def forward(self, batch):
        return twotower_embed(self.tree(), batch, self.cfg)


def twotower_init(cfg: TwoTowerConfig, device=None, generator=None) -> TwoTower:
    _, normal = _drawer(device, generator)
    dt = cfg.dtype
    return TwoTower(cfg, {
        "item_embed": normal((cfg.item_vocab, cfg.embed_dim), dt).mul_(0.01),
        "user_mlp": init_mlp((cfg.user_feat,) + cfg.tower_dims, dt, normal),
        "item_mlp": init_mlp((cfg.embed_dim,) + cfg.tower_dims, dt, normal),
    })


def _unit(x):
    """Rows over their norm, the norm clipped below at 1e-6."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


def _user_tower(params, batch, cfg):
    table = params["item_embed"]
    user = torch.as_tensor(batch["user"], device=table.device).to(cfg.dtype)
    return _unit(mlp(user, params["user_mlp"]))


def twotower_embed(params, batch, cfg: TwoTowerConfig):
    i = mlp(embedding_lookup(params["item_embed"], batch["pos_item"]), params["item_mlp"])
    return _user_tower(params, batch, cfg), _unit(i)


def twotower_loss(params, batch, cfg: TwoTowerConfig, temp: float = 0.05):
    """In-batch sampled softmax (each row's positive vs other rows' items)."""
    u, i = twotower_embed(params, batch, cfg)
    loss = _in_batch_softmax(u, i, temp)
    return loss, {"softmax": loss}


@has_region
def _in_batch_softmax(u: torch.Tensor, i: torch.Tensor, temp: float) -> torch.Tensor:
    logits = torch.matmul(u, i.T).float() / temp
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.diagonal(logits)
    return torch.mean(logz - gold)


def twotower_score_candidates(params, batch, cfg: TwoTowerConfig):
    """retrieval_cand shape: one query [1, F] against candidate ids [N]."""
    c = mlp(embedding_lookup(params["item_embed"], batch["candidates"]),
            params["item_mlp"])
    return torch.einsum("qd,nd->qn", _user_tower(params, batch, cfg), _unit(c))


# -------------------------------------------------------------------- xDeepFM
@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    field_vocab: int = 1_000_000
    embed_dim: int = 10
    cin_layers: tuple = (200, 200, 200)
    mlp_dims: tuple = (400, 400)
    n_dense: int = 13
    dtype: Any = torch.float32


class XDeepFM(TreeModule):
    def forward(self, batch):
        return xdeepfm_forward(self.tree(), batch, self.cfg)


def xdeepfm_init(cfg: XDeepFMConfig, device=None, generator=None) -> XDeepFM:
    _, normal = _drawer(device, generator)
    dt = cfg.dtype
    f0 = cfg.n_sparse
    cin = []
    h_prev = f0
    for h in cfg.cin_layers:
        cin.append(normal((h, h_prev * f0), dt).mul_((h_prev * f0) ** -0.5))
        h_prev = h
    flat = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    return XDeepFM(cfg, {
        "tables": normal((cfg.n_sparse, cfg.field_vocab, cfg.embed_dim), dt).mul_(0.01),
        "linear": normal((cfg.n_sparse, cfg.field_vocab), dt).mul_(0.01),
        "cin": cin,
        "cin_head": normal((sum(cfg.cin_layers), 1), dt).mul_(0.05),
        "mlp": init_mlp((flat,) + cfg.mlp_dims + (1,), dt, normal),
    })


def xdeepfm_forward(params, batch, cfg: XDeepFMConfig):
    x0 = _per_field(params["tables"], batch["sparse_ids"])      # [B, F, D]
    b = x0.shape[0]
    # CIN: x^{k}_h = W^k_h . vec(x^{k-1} (outer) x^0) per embedding dim
    xs = []
    xk = x0
    for w in params["cin"]:
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)              # [B, Hk-1, F, D]
        z = z.reshape(b, -1, cfg.embed_dim)                     # [B, Hk-1*F, D], H major
        xk = torch.einsum("hm,bmd->bhd", w, z)                  # [B, Hk, D]
        xs.append(torch.sum(xk, dim=-1))                        # sum-pool over D
    cin_logit = torch.matmul(torch.cat(xs, -1), params["cin_head"])[:, 0]
    lin_logit = torch.sum(_per_field(params["linear"], batch["sparse_ids"]), dim=1)
    dense = torch.as_tensor(batch["dense"], device=x0.device).to(cfg.dtype)
    deep_in = torch.cat([x0.reshape(b, -1), dense], -1)
    deep_logit = mlp(deep_in, params["mlp"])[:, 0]
    return cin_logit + lin_logit + deep_logit


def xdeepfm_loss(params, batch, cfg: XDeepFMConfig):
    loss = bce_loss(xdeepfm_forward(params, batch, cfg), batch["labels"])
    return loss, {"bce": loss}


# --------------------------------------------------------------------- params
# config type -> (model class, its init, its loss)
ARCHS = {BSTConfig: (BST, bst_init, bst_loss),
         AutoIntConfig: (AutoInt, autoint_init, autoint_loss),
         TwoTowerConfig: (TwoTower, twotower_init, twotower_loss),
         XDeepFMConfig: (XDeepFM, xdeepfm_init, xdeepfm_loss)}


def init_params(cfg, device=None, generator=None) -> TreeModule:
    """The model of ``cfg``'s arch, drawn by its ``*_init``."""
    return ARCHS[type(cfg)][1](cfg, device, generator)


def loss_fn(params, batch, cfg):
    """The training loss of ``cfg``'s arch -> (loss, metrics)."""
    return ARCHS[type(cfg)][2](params, batch, cfg)


def param_tree(model: TreeModule):
    """The model's parameters (the tensors themselves) in ``repro``'s tree."""
    return model.tree()


def params_from_numpy(tree, cfg, device=None) -> TreeModule:
    """``repro``'s parameter pytree as numpy arrays -> the port's model of
    ``cfg``'s arch on ``device`` (the card unless told otherwise), every
    weight in ``cfg.dtype``."""
    dev = resolve_device(device)
    return ARCHS[type(cfg)][0](cfg, map_leaves(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=cfg.dtype), tree))


def params_to_numpy(model: TreeModule):
    """The inverse of :func:`params_from_numpy`: ``repro``'s tree as float32
    numpy arrays."""
    return tree_to_numpy(model.tree())
