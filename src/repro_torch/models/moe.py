"""Mixture-of-Experts FFN, token-choice top-k (port of ``repro.models.moe``,
the single-device path).

Two dispatches, which drop the same claims and compute the same function:

  * ``"einsum"`` (the default): GShard's dense one-hot dispatch.  A
    token-major cumulative count over the ``[T, k]`` claims gives each claim
    its place in its expert's capacity; claims past the capacity drop.
    Every expert's weights are read on every call.
  * ``"sort"``: the n-gram shuffle's bucketize reused as the dispatch.  A
    stable sort of the claims by expert, a ``bincount``, and a scatter of
    each claim into its ``[E, C]`` slot, an overflow slot past the end taking
    the dropped ones; the outputs go back to their tokens by ``index_add_``.

Covers both MoE archs: mixtral-8x7b (8 experts, top-2) and deepseek-moe-16b
(64 fine-grained routed experts, top-6, plus 2 shared experts).
``repro``'s ``moe_ffn_sharded`` (expert parallelism over a mesh) is not
ported yet: it comes with the multi-rank model path.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .layers import swiglu


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "einsum"      # einsum (GShard) | sort (bucketized)

    def capacity(self, tokens_per_group: int) -> int:
        """Slots an expert has: the fair share times the capacity factor,
        rounded up to a multiple of 4, at least 4."""
        c = int(self.capacity_factor * tokens_per_group * self.top_k / self.n_experts)
        return max(4, -(-c // 4) * 4)

    @property
    def d_ff_shared_total(self) -> int:
        """Width of the shared experts' one SwiGLU."""
        return self.d_ff_shared or self.d_ff_expert * self.n_shared


def router_topk(x: torch.Tensor, w_router: torch.Tensor, cfg: MoEConfig):
    """Returns (expert ids [T, k], gates [T, k], logits [T, E]) for tokens
    [T, d].  Logits and softmax in float32; the k largest gates renormalised
    to sum to one, then cast to ``x.dtype``.

    ``repro``'s ``jax.lax.top_k`` puts the lower expert index first among
    equal gates.  ``torch.topk`` specifies no order for equal values on
    either device (the CPU kernel selects by value alone; the CUDA kernel
    selects by radix, then sorts by value), so the port takes the first k
    of a stable descending sort instead, which keeps the lower index first
    as ``jax.lax.top_k`` does.  Exact ties of float32 softmax gates need
    equal router logits, which real inputs do not give."""
    logits = torch.matmul(x.float(), w_router.float())
    gates_all = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, : cfg.top_k], ids[:, : cfg.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return ids, gates.to(x.dtype), logits


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * <fraction routed> . <mean router prob>."""
    probs = torch.softmax(logits, dim=-1).mean(0)
    frac = F.one_hot(ids[:, 0], n_experts).float().mean(0)
    return n_experts * torch.sum(frac * probs)


def claim_positions(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, k) claim's place in its expert's queue, counted token
    major over the ``[T, k]`` claims: a claim drops when its place is at or
    past the capacity."""
    t, k = ids.shape
    claims = F.one_hot(ids, n_experts)                            # [T, k, E]
    pos = torch.cumsum(claims.reshape(t * k, n_experts), dim=0).reshape(
        t, k, n_experts) - 1
    return torch.sum(pos * claims, dim=-1)                        # [T, k]


def _dispatch_einsum(x, ids, gates, cfg: MoEConfig, capacity: int):
    """GShard dense dispatch: one-hot [T, E, C] dispatch and combine tensors."""
    e = cfg.n_experts
    pos = claim_positions(ids, e)
    keep = pos < capacity
    disp = (F.one_hot(ids, e).to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, capacity), capacity + 1)
            .to(x.dtype)[..., None, :])                           # [T, k, E, C+1]
    disp = disp[..., :capacity]
    combine = torch.einsum("tkec,tk->tec", disp, gates)           # [T, E, C]
    dispatch = torch.sum(disp, dim=1)                             # [T, E, C]
    return dispatch, combine


def _dispatch_indices(t: int, ids, gates, cfg: MoEConfig, capacity: int):
    """Bucketized dispatch: the token index and gate of each [E, C] slot, no
    [T, E, C] tensor.  ``slot_token == t`` marks an empty slot."""
    e, k = cfg.n_experts, cfg.top_k
    flat_ids = ids.reshape(-1)                                    # [T*k]
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    counts = torch.bincount(sorted_ids, minlength=e)
    offs = torch.cumsum(counts, 0) - counts
    within = torch.arange(t * k, device=ids.device) - offs[sorted_ids]
    slot = torch.where(within < capacity, sorted_ids * capacity + within, e * capacity)
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.long, device=ids.device)
    slot_token[slot] = order // k                  # dropped claims land past the end
    slot_gate = torch.zeros(e * capacity + 1, dtype=gates.dtype, device=ids.device)
    slot_gate[slot] = gates.reshape(-1)[order]
    return slot_token[:-1], slot_gate[:-1]


def moe_ffn(x: torch.Tensor, params: dict, cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar).

    params: router [d, E] (float32); wg/wu [E, d, ff_e]; wo [E, ff_e, d];
            with shared experts sg/su [d, ff_s] and so [ff_s, d]."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    capacity = cfg.capacity(t)
    ids, gates, logits = router_topk(xt, params["router"], cfg)
    aux = load_balance_loss(logits, ids, cfg.n_experts)

    if cfg.dispatch == "einsum":
        dispatch, combine = _dispatch_einsum(xt, ids, gates, cfg, capacity)
        ein = torch.einsum("tec,td->ecd", dispatch, xt)           # [E, C, d]
        h = F.silu(torch.einsum("ecd,edf->ecf", ein, params["wg"]))
        h = h * torch.einsum("ecd,edf->ecf", ein, params["wu"])
        eo = torch.einsum("ecf,efd->ecd", h, params["wo"])        # [E, C, d]
        y = torch.einsum("tec,ecd->td", combine, eo)
    elif cfg.dispatch == "sort":
        slot_token, slot_gate = _dispatch_indices(t, ids, gates, cfg, capacity)
        x_pad = torch.cat([xt, xt.new_zeros(1, d)])
        expert_in = x_pad[slot_token].reshape(cfg.n_experts, capacity, d)
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["wg"]))
        h = h * torch.einsum("ecd,edf->ecf", expert_in, params["wu"])
        eo = torch.einsum("ecf,efd->ecd", h, params["wo"]).reshape(-1, d)
        eo = eo * slot_gate[:, None]
        y = xt.new_zeros(t + 1, d).index_add_(0, slot_token, eo)[:t]
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")

    if cfg.n_shared:
        y = y + swiglu(xt, params["sg"], params["su"], params["so"])
    return y.reshape(b, s, d), aux


def init_moe_params(d_model: int, cfg: MoEConfig, dtype, normal) -> dict:
    """``repro``'s parameter layout and scales; ``normal(shape, dtype)`` draws
    standard normal values."""
    scale = d_model ** -0.5
    e, ff = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": normal((d_model, e), torch.float32).mul_(scale),
        "wg": normal((e, d_model, ff), dtype).mul_(scale),
        "wu": normal((e, d_model, ff), dtype).mul_(scale),
        "wo": normal((e, ff, d_model), dtype).mul_(ff ** -0.5),
    }
    if cfg.n_shared:
        ffs = cfg.d_ff_shared_total
        p["sg"] = normal((d_model, ffs), dtype).mul_(scale)
        p["su"] = normal((d_model, ffs), dtype).mul_(scale)
        p["so"] = normal((ffs, d_model), dtype).mul_(ffs ** -0.5)
    return p
