"""Shared shapes and cell builder of the four recsys architectures (port of
``repro.configs.recsys_common``).

Embedding tables are row-sharded over `model` (the vocab dimension); batches
shard over ('pod', 'data').  serve_* shapes are a pure forward (no
optimizer state); retrieval_cand scores one query against 1M candidates
(batched dot / full item-tower sweep -- never a loop)."""
from __future__ import annotations

import torch

from .base import Cell, ShapeDef, dp_spec, opt_pspecs, specs_of

SHAPES = {
    "train_batch": ShapeDef("train_batch", "train", {"batch": 65_536}),
    "serve_p99": ShapeDef("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeDef("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": ShapeDef("retrieval_cand", "serve",
                               {"batch": 1, "n_candidates": 1_000_000}),
}

__all__ = ["SHAPES", "dp_spec", "make_recsys_cell", "param_specs"]


def param_specs(init, cfg):
    """The :class:`TensorSpec` tree of ``init(cfg)``'s parameters, drawn on
    the meta device."""
    return specs_of(init(cfg, "meta").tree())


def make_recsys_cell(*, name: str, shape: ShapeDef, mesh, params_sh, pspec,
                     loss, forward, batch_sds, batch_spec,
                     model_flops: float, notes: str = "") -> Cell:
    from repro_torch.training.optimizer import OptimizerConfig, init_state
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import map_leaves, tensors

    if shape.kind == "train":
        meta = map_leaves(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                          params_sh)
        opt_sh = specs_of(init_state(meta))

        def step(params, opt_state, batch):
            for t in tensors(params):
                t.requires_grad_(True)
            return make_train_step(loss, OptimizerConfig())(params, opt_state, batch)
        return Cell(name, shape.name, "train", step, (params_sh, opt_sh, batch_sds),
                    (pspec, opt_pspecs(pspec), batch_spec), donate_argnums=(0, 1),
                    model_flops=3 * model_flops, notes=notes)
    return Cell(name, shape.name, "serve", forward, (params_sh, batch_sds),
                (pspec, batch_spec), model_flops=model_flops, notes=notes)
