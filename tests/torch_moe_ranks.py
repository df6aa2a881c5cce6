"""Rank function of ``test_torch_moe_sharded.py``'s spawned gloo ranks.

Every spawned rank imports the module of the function it runs; this one
imports no JAX, unlike the test file.
"""
import dataclasses

import torch

from repro_torch import configs
from repro_torch.launch.mesh import GridMesh, SumOverRanks, grid_mesh
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.training import train_loop
from repro_torch.training.tree import Stacked, map_leaves

#: the model axis of the grid the MoE cases run on (8 ranks: 2 x 4)
MODEL = 4
#: model sizes whose grid (or 1-D fallback) each rank reports on 8 ranks
GRID_MODELS = (4, 2, 8, 1, 3)


def moe_cfg(n_experts: int, n_shared: int, cf: float, mesh=None) -> tm.MoEConfig:
    """The MoE of ``repro``'s ``test_moe_sharded_matches_local`` (d_ff 32,
    top-2, shared width 24), at capacity factor ``cf``."""
    return tm.MoEConfig(n_experts, 2, 32, n_shared=n_shared, d_ff_shared=24,
                        capacity_factor=cf, dispatch="sort", mesh=mesh,
                        dp_axes=None if mesh is None else "data")


def grid_report(world) -> list:
    """For each of GRID_MODELS: the grid's shape, this rank's place and the
    world ranks of its row and column, or that it fell back to ``world``."""
    out = []
    for model in GRID_MODELS:
        g = grid_mesh(world, model)
        if not isinstance(g, GridMesh):
            out.append(("1-D", g is world, g.shape))
            continue
        out.append((g.shape, g.size, g.data.rank, g.model.rank,
                    g.model.all_gather_object(world.rank),
                    g.data.all_gather_object(world.rank)))
    return out


def _grads_numpy(tree):
    return map_leaves(lambda g: (torch.stack(tuple(g)) if isinstance(g, Stacked) else g)
                      .detach().numpy(), tree)


def moe_case(grid, case, params, x) -> dict:
    """``moe_ffn_sharded`` on this rank's row of ``x`` with its part of
    ``params``: y, aux, and the gradients of sum(y * y) + aux and of
    sum(y * y) in its parameters and its row of ``x``."""
    cfg = moe_cfg(*case, mesh=grid)
    part = {k: torch.from_numpy(v) for k, v in tm.shard_moe_params(params, cfg).items()}
    rows = grid.shape["data"]
    b = x.shape[0] // rows
    out = {}
    for with_aux in (True, False):
        p = {k: v.clone().requires_grad_(True) for k, v in part.items()}
        xl = torch.from_numpy(x[grid.data.rank * b:(grid.data.rank + 1) * b]).requires_grad_(True)
        y, aux = tm.moe_ffn_sharded(xl, p, cfg)
        loss = SumOverRanks.apply((y * y).sum().reshape(1), grid.data)[0]
        if with_aux:
            loss = loss + aux
            out.update(y=y.detach().numpy(), aux=float(aux.detach()))
        grads = torch.autograd.grad(loss, [*p.values(), xl])
        out["grads" if with_aux else "grads_yy"] = {
            k: g.numpy() for k, g in zip([*p, "x"], grads)}
    return out


def lm_case(grid, arch: str, tree: dict, batch: dict) -> dict:
    """The arch's REDUCED transformer with ``moe.mesh`` on ``grid``: the
    global loss, its ce and aux, and the gradient in this rank's
    parameters, from ``repro``'s tree."""
    cfg = configs.get(arch).make_reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, mesh=grid,
                                                           dp_axes="data"))
    model = tt.params_from_numpy(tree, cfg, device=grid.device).requires_grad_(True)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = train_loop.value_and_grad(lambda p, x: tt.loss_fn(model, x),
                                                     tt.param_tree(model), b)
    return {"loss": float(loss), "ce": float(metrics["ce"]), "aux": float(metrics["aux"]),
            "grads": _grads_numpy(grads)}


def sharded_rank(world, moe_cases, moe_params, x, lm_cases) -> dict:
    """Everything the test holds against ``repro``, on one rank of 8."""
    grid = grid_mesh(world, MODEL)
    return {"grid": grid_report(world),
            "moe": [moe_case(grid, case, params, x)
                    for case, params in zip(moe_cases, moe_params)],
            "lm": [lm_case(grid, *c) for c in lm_cases],
            "comm_bytes": grid.comm_bytes}


def grid_moe_rank(world, model: int, case, params, x) -> dict:
    """One MoE case on a grid of ``model`` columns over ``world``."""
    return moe_case(grid_mesh(world, model), case, params, x)
