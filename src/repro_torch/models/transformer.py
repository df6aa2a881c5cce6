"""Causal-LM transformer for the five LM archs (port of
``repro.models.transformer``).

One config, three structural switches:
  attention kind : gqa (llama3 / phi3 / deepseek / mixtral) | mla (minicpm3)
  window         : sliding-window attention (mixtral): a ring-buffer decode
                   cache bounded by the window
  moe            : None (dense SwiGLU) | MoEConfig (mixtral, deepseek-moe)

Decode keeps a cache per arch: GQA's K/V ring (windowed) or linear cache,
and MLA's absorbed latent cache (the rank-r ``ckv`` plus the shared rope
key), attended to in latent space.  Prefill runs MLA in its non-absorbed
form.

PyTorch form: an ``nn.Module`` per block, a Python loop over the layers in
place of ``lax.scan``, weights in ``repro``'s layout (``[d_in, d_out]``,
experts ``[E, ...]``) so that :func:`params_from_numpy` carries ``repro``'s
initialised parameters across unchanged.  :func:`init_params` draws the
port's own from a ``torch.Generator`` on the target device.  The entry
points take their device from the model, which :func:`init_params` and
:func:`params_from_numpy` place on the card unless told otherwise.

Training.  The weights are registered frozen, so serving builds no
autograd graph; a trainer calls ``model.requires_grad_(True)``.  With
``LMConfig.remat`` (``repro``'s default) a forward that records gradients
runs each block under ``torch.utils.checkpoint`` (non-reentrant), which
keeps only the block's inputs and recomputes its activations in the
backward, as ``jax.checkpoint(body)`` does in ``repro``.
:func:`param_tree` gives the model's parameters in ``repro``'s tree, each
layer leaf a :class:`~repro_torch.training.tree.Stacked` of the layers'
tensors, and :func:`params_to_numpy` that tree stacked ``[L, ...]``.

On a grid of ranks.  With ``cfg.moe.mesh`` set (a
``launch.mesh.GridMesh``, as ``repro``'s cell builder sets it), each MoE
layer runs ``moe.moe_ffn_sharded``, and :func:`init_params` and
:func:`params_from_numpy` keep only this rank's part of each expert leaf.
Every rank calls :func:`forward` and :func:`loss_fn` with the same global
batch and takes its data row's block of it; everything but the MoE FFN is
held whole on every rank, and the ranks of a row compute it alike.  The
loss is the mean of the rows' losses (equal token counts), and a hook on
each of those replicated parameters sums its gradient over the data group,
so every rank's gradient is the global loss's.  (``repro``'s cell builder
also splits attention over the model axis: a layout of one compiled
program, not another result.)

Not ported: ``repro``'s ``shard_activations`` / ``_constrain`` (sharding
annotations for a TPU mesh, which compute nothing) and its
``sub_quadratic`` property, which sits after a ``return`` in ``_constrain``
and is unreachable.  Nor is ``scan_layers``, which chooses how ``repro``
compiles its layers: the port loops over its layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.launch.mesh import SumOverRanks, axis_view
from repro_torch.training.tree import Stacked

from .layers import (NEG_INF, apply_rope, cross_entropy_loss, decode_attention,
                     gqa_attention, rms_norm, swiglu)
from .moe import MoEConfig, init_moe_params, moe_ffn, moe_ffn_sharded, shard_moe_params


@dataclass(frozen=True)
class AttentionConfig:
    kind: str                    # "gqa" | "mla"
    n_heads: int
    n_kv: int
    d_head: int
    window: int | None = None
    rope_theta: float = 10_000.0
    # MLA dims (DeepSeek-V2 style):
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    # head padding (e.g. phi3's 40 heads to 48 for a 16-way split): padded
    # heads are masked to zero before the output projection, so the function
    # computed is exactly the n_heads-head model.  0 = no padding.
    pad_heads_to: int = 0

    @property
    def h_eff(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def kv_eff(self) -> int:
        return self.h_eff // (self.n_heads // self.n_kv)

    @property
    def head_mask_needed(self) -> bool:
        return self.h_eff != self.n_heads


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab_size: int
    d_ff: int
    attn: AttentionConfig
    moe: MoEConfig | None = None
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    q_chunk: int = 0             # query chunking for long prefill
    loss_chunks: int = 8
    remat: bool = True           # recompute each block in the backward
    aux_loss_weight: float = 0.01


GQA_KEYS = ("wq", "wk", "wv", "wo")
MLA_KEYS = ("wdq", "wuq", "wdkv", "wukv", "wkr", "wo")


def _adopt(module: nn.Module, tensors: dict) -> None:
    """Register each tensor as a frozen parameter of ``module``, sharing its
    storage (a full-width model is never held twice)."""
    for name, t in tensors.items():
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


def _head_mask(a: AttentionConfig, out: torch.Tensor) -> torch.Tensor:
    """Zero the padded heads' outputs ([..., H, d]): the computed function
    stays the exact n_heads model."""
    if not a.head_mask_needed:
        return out
    mask = (torch.arange(a.h_eff, device=out.device) < a.n_heads).to(out.dtype)
    return out * mask[:, None]


class GQAAttention(nn.Module):
    """Grouped-query attention with RoPE; K/V cache [B, T, KV, d]."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        self.a = cfg.attn
        _adopt(self, {k: p[k] for k in GQA_KEYS})

    def forward(self, x, positions, q_chunk: int):
        a = self.a
        b, s, _ = x.shape
        q = torch.matmul(x, self.wq).reshape(b, s, a.h_eff, a.d_head)
        k = torch.matmul(x, self.wk).reshape(b, s, a.kv_eff, a.d_head)
        v = torch.matmul(x, self.wv).reshape(b, s, a.kv_eff, a.d_head)
        q = apply_rope(q, positions, a.rope_theta)
        k = apply_rope(k, positions, a.rope_theta)
        out = gqa_attention(q, k, v, q_positions=positions, k_positions=positions,
                            window=a.window, q_chunk=q_chunk)
        out = _head_mask(a, out)
        return torch.matmul(out.reshape(b, s, -1), self.wo), {"k": k, "v": v}

    def decode(self, h, cache: dict, slot: int, live, positions):
        """h: [B, 1, d] -> [B, d]; writes this token's K/V at ``slot``."""
        a = self.a
        b = h.shape[0]
        q = torch.matmul(h, self.wq).reshape(b, a.h_eff, a.d_head)
        k = torch.matmul(h, self.wk).reshape(b, a.kv_eff, a.d_head)
        v = torch.matmul(h, self.wv).reshape(b, a.kv_eff, a.d_head)
        q = apply_rope(q[:, None], positions, a.rope_theta)[:, 0]
        cache["k"][:, slot] = apply_rope(k[:, None], positions, a.rope_theta)[:, 0]
        cache["v"][:, slot] = v
        attn = decode_attention(q, cache["k"], cache["v"], valid=live)
        attn = _head_mask(a, attn)
        return torch.matmul(attn.reshape(b, -1), self.wo)


class MLAAttention(nn.Module):
    """Multi-head latent attention: low-rank q and kv projections and one
    rope key shared by every head.  Latent cache: ckv [B, T, r], kr
    [B, T, d_rope]."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        self.a = cfg.attn
        _adopt(self, {k: p[k] for k in MLA_KEYS})

    def forward(self, x, positions, q_chunk: int):
        """The non-absorbed form, for prefill and training."""
        a = self.a
        b, s, _ = x.shape
        cq = torch.matmul(x, self.wdq)
        q = torch.matmul(cq, self.wuq).reshape(b, s, a.h_eff, a.d_nope + a.d_rope)
        qn, qr = q[..., : a.d_nope], q[..., a.d_nope:]
        qr = apply_rope(qr, positions, a.rope_theta)
        ckv = torch.matmul(x, self.wdkv)                               # latent cache
        kv = torch.matmul(ckv, self.wukv).reshape(b, s, a.h_eff, a.d_nope + a.d_v)
        kn, v = kv[..., : a.d_nope], kv[..., a.d_nope:]
        kr = apply_rope(torch.matmul(x, self.wkr)[:, :, None, :],
                        positions, a.rope_theta)                       # shared head
        k = torch.cat([kn, kr.expand(b, s, a.h_eff, a.d_rope)], dim=-1)
        q_full = torch.cat([qn, qr], dim=-1)
        out = gqa_attention(q_full, k, v, q_positions=positions, k_positions=positions,
                            window=a.window, q_chunk=q_chunk)
        out = _head_mask(a, out)
        out = torch.matmul(out.reshape(b, s, -1), self.wo)
        return out, {"ckv": ckv, "kr": kr[:, :, 0, :]}

    def decode(self, h, cache: dict, slot: int, live, positions):
        """The absorbed form: attention entirely in the latent space."""
        a = self.a
        b = h.shape[0]
        cq = torch.matmul(h, self.wdq)
        q = torch.matmul(cq, self.wuq).reshape(b, 1, a.h_eff, a.d_nope + a.d_rope)
        qn = q[..., : a.d_nope]
        qr = apply_rope(q[..., a.d_nope:], positions, a.rope_theta)
        cache["ckv"][:, slot] = torch.matmul(h, self.wdkv)[:, 0]
        cache["kr"][:, slot] = apply_rope(torch.matmul(h, self.wkr), positions,
                                          a.rope_theta)[:, 0]
        ckv, kr = cache["ckv"], cache["kr"]
        wuk = self.wukv.reshape(a.kv_lora, a.h_eff, a.d_nope + a.d_v)
        q_lat = torch.einsum("bhn,rhn->bhr", qn[:, 0], wuk[..., : a.d_nope])
        scores = (torch.einsum("bhr,btr->bht", q_lat, ckv)
                  + torch.einsum("bhp,btp->bht", qr[:, 0], kr)).float()
        scores = scores * (a.d_nope + a.d_rope) ** -0.5
        scores = torch.where(live[None, None], scores, NEG_INF)
        p = torch.softmax(scores, dim=-1).to(ckv.dtype)
        o_lat = torch.einsum("bht,btr->bhr", p, ckv)
        o = torch.einsum("bhr,rhv->bhv", o_lat, wuk[..., a.d_nope:])
        o = _head_mask(a, o)
        return torch.matmul(o.reshape(b, -1), self.wo)


class FeedForward(nn.Module):
    """Dense SwiGLU: wg/wu [d, ff], wo [ff, d]."""

    def __init__(self, p: dict):
        super().__init__()
        _adopt(self, p)

    def forward(self, x):
        return swiglu(x, self.wg, self.wu, self.wo), x.new_zeros((), dtype=torch.float32)


class MoE(nn.Module):
    """Token-choice top-k experts (``moe.moe_ffn``, or ``moe_ffn_sharded``
    when ``cfg.mesh`` is set) and their parameters (this rank's part, on a
    mesh)."""

    def __init__(self, cfg: MoEConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        _adopt(self, p)

    def forward(self, x):
        ffn = moe_ffn if self.cfg.mesh is None else moe_ffn_sharded
        return ffn(x, dict(self.named_parameters()), self.cfg)


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then + ffn(norm(x))."""

    def __init__(self, cfg: LMConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        _adopt(self, {"ln1": p["ln1"], "ln2": p["ln2"]})
        self.attn = (GQAAttention if cfg.attn.kind == "gqa" else MLAAttention)(cfg, p)
        self.ffn = MoE(cfg.moe, p["ffn"]) if cfg.moe is not None else FeedForward(p["ffn"])

    def forward(self, x, positions):
        eps = self.cfg.norm_eps
        h, cache = self.attn(rms_norm(x, self.ln1, eps), positions, self.cfg.q_chunk)
        x = x + h
        h, aux = self.ffn(rms_norm(x, self.ln2, eps))
        return x + h, aux, cache

    def decode(self, x, cache: dict, slot: int, live, positions):
        eps = self.cfg.norm_eps
        out = self.attn.decode(rms_norm(x, self.ln1, eps), cache, slot, live, positions)
        x = x + out[:, None]
        h, _ = self.ffn(rms_norm(x, self.ln2, eps))
        return x + h


class Transformer(nn.Module):
    """The whole LM: embedding, blocks, final norm, output head."""

    def __init__(self, cfg: LMConfig, embed, layers: list[dict], final_norm, lm_head):
        super().__init__()
        self.cfg = cfg
        _adopt(self, {"embed": embed, "final_norm": final_norm, "lm_head": lm_head})
        self.layers = nn.ModuleList(Block(cfg, p) for p in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ----------------------------------------------------------------------- params
def _layer_params(cfg: LMConfig, normal) -> dict:
    a, d, dt = cfg.attn, cfg.d_model, cfg.dtype
    s = d ** -0.5
    if a.kind == "gqa":
        p = {"wq": normal((d, a.h_eff * a.d_head), dt).mul_(s),
             "wk": normal((d, a.kv_eff * a.d_head), dt).mul_(s),
             "wv": normal((d, a.kv_eff * a.d_head), dt).mul_(s),
             "wo": normal((a.h_eff * a.d_head, d), dt).mul_((a.n_heads * a.d_head) ** -0.5)}
    else:
        qd, rr = a.d_nope + a.d_rope, a.kv_lora
        p = {"wdq": normal((d, a.q_lora), dt).mul_(s),
             "wuq": normal((a.q_lora, a.h_eff * qd), dt).mul_(a.q_lora ** -0.5),
             "wdkv": normal((d, rr), dt).mul_(s),
             "wukv": normal((rr, a.h_eff * (a.d_nope + a.d_v)), dt).mul_(rr ** -0.5),
             "wkr": normal((d, a.d_rope), dt).mul_(s),
             "wo": normal((a.h_eff * a.d_v, d), dt).mul_((a.n_heads * a.d_v) ** -0.5)}
    if cfg.moe is not None:
        p["ffn"] = init_moe_params(d, cfg.moe, dt, normal)
    else:
        f = cfg.d_ff
        p["ffn"] = {"wg": normal((d, f), dt).mul_(d ** -0.5),
                    "wu": normal((d, f), dt).mul_(d ** -0.5),
                    "wo": normal((f, d), dt).mul_(f ** -0.5)}
    p["ln1"] = torch.ones(d, dtype=dt, device=p["wo"].device)
    p["ln2"] = torch.ones(d, dtype=dt, device=p["wo"].device)
    return p


def init_params(cfg: LMConfig, device=None,
                generator: torch.Generator | None = None) -> Transformer:
    """A model with ``repro``'s parameter shapes and scales, drawn from
    ``generator`` (seed 0 on the device if none is given) straight on the
    device: the card unless ``device`` says otherwise.  With
    ``cfg.moe.mesh`` set, the draws are the single-device model's and each
    MoE leaf keeps this rank's part (``moe.init_moe_params``)."""
    dev = resolve_device(device)
    g = generator
    if g is None and dev.type != "meta":      # meta tensors draw nothing
        g = torch.Generator(dev).manual_seed(0)

    def normal(shape, dtype):
        return torch.randn(shape, generator=g, dtype=dtype, device=dev)

    layers = [_layer_params(cfg, normal) for _ in range(cfg.n_layers)]
    d, v = cfg.d_model, cfg.vocab_size
    return Transformer(cfg,
                       embed=normal((v, d), cfg.dtype).mul_(d ** -0.5),
                       layers=layers,
                       final_norm=torch.ones(d, dtype=cfg.dtype, device=dev),
                       lm_head=normal((d, v), cfg.dtype).mul_(d ** -0.5))


def params_from_numpy(tree: dict, cfg: LMConfig, device=None) -> Transformer:
    """``repro``'s parameter pytree as numpy arrays (layers stacked
    ``[L, ...]``, MoE experts ``[E, ...]``) -> the port's model on
    ``device`` (the card unless told otherwise), computing the same function.
    The router stays float32; every other weight takes ``cfg.dtype``.  With
    ``cfg.moe.mesh`` set, each MoE leaf is cut to this rank's part."""
    dev = resolve_device(device)

    def tensor(a, dtype=cfg.dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    stacked = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        p = {k: tensor(v[i]) for k, v in stacked.items() if k != "ffn"}
        ffn = {k: v[i] for k, v in stacked["ffn"].items()}
        if cfg.moe is not None and cfg.moe.mesh is not None:
            ffn = shard_moe_params(ffn, cfg.moe)
        p["ffn"] = {k: tensor(v, torch.float32 if k == "router" else cfg.dtype)
                    for k, v in ffn.items()}
        layers.append(p)
    return Transformer(cfg, embed=tensor(tree["embed"]), layers=layers,
                       final_norm=tensor(tree["final_norm"]),
                       lm_head=tensor(tree["lm_head"]))


def _layer_tree(block: Block) -> dict:
    """One block's parameters under ``repro``'s per-layer names."""
    tree = dict(block.named_parameters(recurse=False))
    tree.update(block.attn.named_parameters())
    tree["ffn"] = dict(block.ffn.named_parameters())
    return tree


def param_tree(model: Transformer) -> dict:
    """The model's parameters (the tensors themselves, not copies) in
    ``repro``'s tree: ``embed``, ``final_norm``, ``lm_head`` and ``layers``,
    whose every leaf is a :class:`Stacked` of the layers' tensors, the port's
    form of ``repro``'s ``[L, ...]`` leaf."""
    per_layer = [_layer_tree(block) for block in model.layers]

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else Stacked(t[k] for t in trees) for k, v in trees[0].items()}

    return {"embed": model.embed, "layers": stack(per_layer),
            "final_norm": model.final_norm, "lm_head": model.lm_head}


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of :func:`params_from_numpy`: ``repro``'s parameter tree
    as float32 numpy arrays, layers stacked ``[L, ...]`` (a bf16 weight
    widens exactly)."""
    def host(leaf):
        if isinstance(leaf, dict):
            return {k: host(v) for k, v in leaf.items()}
        t = torch.stack(tuple(leaf)) if isinstance(leaf, Stacked) else leaf
        return t.detach().float().cpu().numpy()

    return host(param_tree(model))


# ---------------------------------------------------------------------- forward
def _rows(cfg: LMConfig):
    """The data axis's mesh of the MoE grid, or None off a grid."""
    if cfg.moe is None or cfg.moe.mesh is None:
        return None
    return axis_view(cfg.moe.mesh, "data")


def row_block(cfg: LMConfig, t: torch.Tensor) -> torch.Tensor:
    """This rank's data row's block of a global batch ``t`` [B, ...] (all of
    it off a grid); B must divide over the rows."""
    dp = _rows(cfg)
    if dp is None:
        return t
    b, rem = divmod(t.shape[0], dp.size)
    if rem:
        raise ValueError(f"a batch of {t.shape[0]} does not split over {dp.size} data rows")
    return t[dp.rank * b:(dp.rank + 1) * b]


def _sum_grads_over_rows(model: Transformer, dp) -> None:
    """Hooks that sum the gradient of each parameter outside the MoE FFN over
    the data group, once a parameter requires grad: the ranks of a row
    compute those alike, each on its row's tokens."""
    hooked = model.__dict__.setdefault("_row_hooked", set())
    for name, p in model.named_parameters():
        if p.requires_grad and ".ffn." not in name and name not in hooked:
            p.register_hook(dp.all_reduce)
            hooked.add(name)


def forward(model: Transformer, tokens: torch.Tensor, collect_cache: bool = False):
    """tokens [B, S] -> (x_final [B, S, d], aux_loss, cache or None); the
    cache stacks each layer's ``[B, S, ...]`` entries to ``[L, B, S, ...]``.
    On a grid (``cfg.moe.mesh``) ``tokens`` is the global batch and the
    outputs are this rank's data row's block of it."""
    cfg = model.cfg
    dp = _rows(cfg)
    if dp is not None:
        tokens = row_block(cfg, tokens)
        if torch.is_grad_enabled() and dp.size > 1:
            _sum_grads_over_rows(model, dp)
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=model.device)
    x = model.embed[tokens.to(model.device)].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    aux, caches = [], []
    for layer in model.layers:
        if remat:
            x, a, c = checkpoint(layer, x, positions, use_reentrant=False)
        else:
            x, a, c = layer(x, positions)
        aux.append(a)
        if collect_cache:
            caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    cache = ({k: torch.stack([c[k] for c in caches]) for k in caches[0]}
             if collect_cache else None)
    return x, torch.stack(aux).sum(), cache


def loss_fn(model: Transformer, batch: dict):
    """``repro``'s training loss: chunked cross entropy plus the weighted MoE
    auxiliary loss -> (loss, {"ce", "aux"}).  Differentiable in the model's
    parameters once they require grad.  On a grid, the cross entropy is the
    mean of the data rows' (each computed on its row), the aux the grid's
    ``pmean``: the global batch's loss on every rank."""
    cfg = model.cfg
    x, aux, _ = forward(model, batch["tokens"])
    labels = row_block(cfg, batch["labels"]).to(model.device)
    ce = cross_entropy_loss(x, model.lm_head, labels, cfg.loss_chunks)
    dp = _rows(cfg)
    if dp is not None and dp.size > 1:
        ce = SumOverRanks.apply(ce.reshape(1), dp)[0] / dp.size
    return ce + cfg.aux_loss_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------- serving
def cache_len(cfg: LMConfig, max_seq: int) -> int:
    w = cfg.attn.window
    return min(max_seq, w) if w else max_seq


def init_cache(cfg: LMConfig, batch: int, max_seq: int, device=None) -> dict:
    a = cfg.attn
    t = cache_len(cfg, max_seq)
    dev = resolve_device(device)
    if a.kind == "mla":
        shapes = {"ckv": (cfg.n_layers, batch, t, a.kv_lora),
                  "kr": (cfg.n_layers, batch, t, a.d_rope)}
    else:
        shapes = {"k": (cfg.n_layers, batch, t, a.kv_eff, a.d_head),
                  "v": (cfg.n_layers, batch, t, a.kv_eff, a.d_head)}
    return {k: torch.zeros(shape, dtype=cfg.dtype, device=dev) for k, shape in shapes.items()}


def prefill(model: Transformer, tokens: torch.Tensor, max_seq: int):
    """tokens [B, S] -> (cache filled for S positions, last-token logits
    [B, V] in float32).  Position p sits at slot p % T of a cache of T
    slots: the last T positions rolled into place when S >= T, else the S
    positions padded with zeros to T."""
    x, _, cache = forward(model, tokens, collect_cache=True)
    logits = torch.matmul(x[:, -1], model.lm_head).float()
    t = cache_len(model.cfg, max_seq)
    s = tokens.shape[1]

    def place(c):  # [L, B, S, ...] -> [L, B, T, ...]
        if s >= t:
            return torch.roll(c[:, :, s - t:], shifts=s % t, dims=2)
        out = c.new_zeros(c.shape[:2] + (t,) + c.shape[3:])
        out[:, :, :s] = c
        return out

    return {k: place(c) for k, c in cache.items()}, logits


def _ring_valid(t: int, slot: int, pos: int, device) -> torch.Tensor:
    """Ring-buffer validity: slots written in the last min(pos, t) steps."""
    idx = torch.arange(t, device=device)
    filled = min(pos, t)
    age = (slot - idx) % t          # 0 = current write slot, 1 = previous, ...
    return (age > 0) & (age <= filled)


def decode_step(model: Transformer, cache: dict, token: torch.Tensor, pos: int):
    """One decode step.  token [B], ``pos`` the next position's index.
    Writes the token's cache entries in place and returns (logits [B, V] in
    float32, the cache)."""
    cfg = model.cfg
    a = cfg.attn
    dev = model.device
    t = next(iter(cache.values())).shape[2]
    pos = int(pos)
    slot = pos % t if a.window else min(pos, t - 1)
    idx = torch.arange(t, device=dev)
    valid = _ring_valid(t, slot, pos, dev) if a.window else idx < pos
    live = valid | (idx == slot)
    x = model.embed[token.to(dev)[:, None]].to(cfg.dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    for i, layer in enumerate(model.layers):
        x = layer.decode(x, {k: c[i] for k, c in cache.items()}, slot, live, positions)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return torch.matmul(x[:, 0], model.lm_head).float(), cache
