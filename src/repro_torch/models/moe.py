"""Mixture-of-Experts FFN, token-choice top-k (port of ``repro.models.moe``).

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

:func:`moe_ffn_sharded` is ``repro``'s ``shard_map`` MoE on a (data, model)
grid of ranks (``launch.mesh.grid_mesh``): each rank routes its data row's
tokens, dispatches them by sort, runs its part of the experts (expert
parallel, or every expert at ``d_ff / tp`` when the experts are fewer than
the model ranks), and the partial outputs are summed over the model group.
:func:`shard_moe_params` cuts a whole parameter tree to one rank's part.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import Replicated, SumOverRanks, axis_view, has_region

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
    # distributed execution (None = the single-device path): a GridMesh, or
    # the 1-D data mesh grid_mesh falls back to
    mesh: Any = None
    dp_axes: Any = None           # the batch axis: "data", or None
    tp_axis: str = "model"

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
    counts = torch.zeros(e, dtype=torch.long, device=ids.device).index_add_(
        0, sorted_ids, torch.ones_like(sorted_ids))
    offs = torch.cumsum(counts, 0) - counts
    within = torch.arange(t * k, device=ids.device) - offs[sorted_ids]
    slot = torch.where(within < capacity, sorted_ids * capacity + within, e * capacity)
    slot_token = torch.full((e * capacity + 1,), t, dtype=torch.long, device=ids.device)
    slot_token[slot] = order // k                  # dropped claims land past the end
    slot_gate = torch.zeros(e * capacity + 1, dtype=gates.dtype, device=ids.device)
    slot_gate[slot] = gates.reshape(-1)[order]
    return slot_token[:-1], slot_gate[:-1]


def _sorted_experts(xt, slot_token, slot_gate, params: dict, capacity: int):
    """The experts of ``params`` (``wg``/``wu`` [E, d, f], ``wo`` [E, f, d])
    on their ``[E * C]`` slots of the tokens ``xt`` [T, d]: gather, SwiGLU,
    gate, and ``index_add_`` back to the tokens -> [T, d]."""
    t, d = xt.shape
    x_pad = torch.cat([xt, xt.new_zeros(1, d)])
    expert_in = x_pad[slot_token].reshape(params["wg"].shape[0], capacity, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["wg"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, params["wu"])
    eo = torch.einsum("ecf,efd->ecd", h, params["wo"]).reshape(-1, d)
    eo = eo * slot_gate[:, None]
    return xt.new_zeros(t + 1, d).index_add_(0, slot_token, eo)[:t]


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
        y = _sorted_experts(xt, slot_token, slot_gate, params, capacity)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")

    if cfg.n_shared:
        y = y + swiglu(xt, params["sg"], params["su"], params["so"])
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------- sharded
def _tp(cfg: MoEConfig):
    """(the model axis's mesh or None, its size, this rank's index on it)."""
    tp = axis_view(cfg.mesh, cfg.tp_axis)
    return (tp, tp.size, tp.rank) if tp is not None else (None, 1, 0)


def expert_parallel(cfg: MoEConfig, tp_size: int) -> bool:
    """``repro``'s layout rule: each model rank owns ``E / tp`` whole
    experts when ``tp`` divides ``E`` (EP), else every rank holds every
    expert at ``d_ff / tp`` (ffTP)."""
    return cfg.n_experts % tp_size == 0


def shard_leaf(name: str, leaf, cfg: MoEConfig, tp_size: int, tp_rank: int):
    """Rank ``tp_rank``'s part of the MoE leaf ``name`` (a numpy array or a
    tensor), by ``repro``'s ``w_specs`` and ``s_specs``: the router whole;
    EP splits the experts' axis 0, ffTP ``wg``/``wu``'s axis 2 and ``wo``'s
    axis 1; the shared ``sg``/``su`` axis 1 and ``so`` axis 0.  A copy, so a
    whole leaf drawn only to be cut is freed."""
    if name == "router" or tp_size == 1:
        return leaf
    if name in ("wg", "wu", "wo"):
        axis = 0 if expert_parallel(cfg, tp_size) else (1 if name == "wo" else 2)
    else:
        axis = {"sg": 1, "su": 1, "so": 0}[name]
    n, rem = divmod(leaf.shape[axis], tp_size)
    if rem:
        raise ValueError(f"{name} axis {axis} of {leaf.shape[axis]} does not split "
                         f"over {tp_size} model ranks")
    idx = [slice(None)] * leaf.ndim
    idx[axis] = slice(tp_rank * n, (tp_rank + 1) * n)
    part = leaf[tuple(idx)]
    return part.copy() if isinstance(part, np.ndarray) else part.clone()


def shard_moe_params(tree: dict, cfg: MoEConfig) -> dict:
    """This rank's part of a whole MoE parameter tree (``repro``'s layout,
    numpy arrays or tensors) on ``cfg.mesh``'s model axis."""
    _, tp_size, tp_rank = _tp(cfg)
    return {k: shard_leaf(k, v, cfg, tp_size, tp_rank) for k, v in tree.items()}


def _data_axis(cfg: MoEConfig):
    """The batch axis's mesh, or None; ``repro``'s ``dp_axes`` "data" or
    None (then the grid must have one row: the port splits no other way)."""
    dp = axis_view(cfg.mesh, "data")
    if cfg.dp_axes in ("data", ("data",)):
        return dp
    if cfg.dp_axes is None and (dp is None or dp.size == 1):
        return None
    raise ValueError(f"dp_axes {cfg.dp_axes!r}: the port's grids split the batch "
                     "over 'data'")


@has_region
def moe_ffn_sharded(x: torch.Tensor, params: dict, cfg: MoEConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``repro``'s ``moe_ffn_sharded`` on this rank of ``cfg.mesh``.

    ``x`` [B_local, S, d] is this rank's data row's block of the batch (the
    block ``shard_map`` hands it); ``params`` is this rank's part
    (:func:`shard_moe_params`).  The rank routes its row's T tokens, sizes
    the capacity on T, dispatches by sort, keeps the slots of its own
    ``E / tp`` experts (EP) or all of them (ffTP), runs its experts and its
    slice of the shared experts, and the partial outputs are all-reduced
    over the model group (``psum``).  The aux loss is averaged over every
    rank of the grid (``pmean``).  Returns (y [B_local, S, d], aux).

    Gradients: ``x`` is replicated over the model group and the router over
    the grid, the expert and shared slices over the data group, so each
    rank's ``torch.autograd.grad`` gives the gradient of the global
    function in its own part, as ``jax.grad`` through ``shard_map`` does.
    """
    mesh = cfg.mesh
    world = getattr(mesh, "world", mesh)
    tp, tp_size, m = _tp(cfg)
    dp = _data_axis(cfg)
    ep = expert_parallel(cfg, tp_size)
    e_local = cfg.n_experts // tp_size if ep else cfg.n_experts
    b, s, d = x.shape
    if tp is not None:
        x = Replicated.apply(x, tp)
    router = Replicated.apply(params["router"], world)
    w = {k: Replicated.apply(v, dp) if dp is not None else v
         for k, v in params.items() if k != "router"}
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    capacity = cfg.capacity(t)
    ids, gates, logits = router_topk(xt, router, cfg)
    aux = load_balance_loss(logits, ids, cfg.n_experts)
    slot_token, slot_gate = _dispatch_indices(t, ids, gates, cfg, capacity)
    if ep:                      # this rank gathers only its own experts' tokens
        lo = m * e_local * capacity
        slot_token = slot_token[lo:lo + e_local * capacity]
        slot_gate = slot_gate[lo:lo + e_local * capacity]
    y = _sorted_experts(xt, slot_token, slot_gate, w, capacity)
    if cfg.n_shared:
        y = y + swiglu(xt, w["sg"], w["su"], w["so"])      # d_ff_shared split over tp
    if tp is not None:
        y = SumOverRanks.apply(y, tp)
    aux = SumOverRanks.apply(aux.reshape(1), world)[0] / world.size
    return y.reshape(b, s, d), aux


def init_moe_params(d_model: int, cfg: MoEConfig, dtype, normal) -> dict:
    """``repro``'s parameter layout and scales; ``normal(shape, dtype)`` draws
    standard normal values.  With ``cfg.mesh`` set, each leaf is drawn whole
    (the draws stay the single-device model's) and cut to this rank's part
    at once, so one whole leaf at most is held at a time."""
    _, tp_size, tp_rank = _tp(cfg)
    scale = d_model ** -0.5
    e, ff = cfg.n_experts, cfg.d_ff_expert
    shapes = {"router": ((d_model, e), torch.float32, scale),
              "wg": ((e, d_model, ff), dtype, scale),
              "wu": ((e, d_model, ff), dtype, scale),
              "wo": ((e, ff, d_model), dtype, ff ** -0.5)}
    if cfg.n_shared:
        ffs = cfg.d_ff_shared_total
        shapes.update(sg=((d_model, ffs), dtype, scale), su=((d_model, ffs), dtype, scale),
                      so=((ffs, d_model), dtype, ffs ** -0.5))
    return {k: shard_leaf(k, normal(shape, dt).mul_(sc), cfg, tp_size, tp_rank)
            for k, (shape, dt, sc) in shapes.items()}
