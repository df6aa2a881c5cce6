"""autoint [arXiv:1810.11921]: 39 sparse fields, embed 16, 3 self-attention
interaction layers (2 heads, d_attn 32)."""
from __future__ import annotations

import torch

from repro_torch.models import recsys as R
from .base import P, ArchDef, ShapeDef, TensorSpec, register, replicated, shard_if
from .recsys_common import SHAPES, dp_spec, make_recsys_cell, param_specs

FULL = R.AutoIntConfig(n_sparse=39, field_vocab=1_000_000, embed_dim=16,
                       n_attn_layers=3, n_heads=2, d_attn=32)
REDUCED = R.AutoIntConfig(n_sparse=5, field_vocab=200, embed_dim=8,
                          n_attn_layers=2, d_attn=8)


def _flops(cfg: R.AutoIntConfig, batch: int) -> float:
    f = cfg.n_sparse + 1
    per_layer = 3 * 2 * f * cfg.embed_dim * cfg.d_attn + 2 * f * f * cfg.d_attn * 2
    return float(batch * (cfg.n_attn_layers * per_layer + 2 * f * cfg.d_attn))


def build_cell(cfg_factory, shape: ShapeDef, mesh):
    cfg = FULL
    params_sh = param_specs(R.autoint_init, cfg)
    pspec = replicated(params_sh)
    pspec["tables"] = P(None, shard_if(mesh, cfg.field_vocab, "model"), None)
    b = shape.dims.get("n_candidates", shape.dims["batch"])
    dp = dp_spec(mesh)
    batch_sds = {"sparse_ids": TensorSpec((b, cfg.n_sparse), torch.int32),
                 "dense": TensorSpec((b, cfg.n_dense), torch.float32),
                 "labels": TensorSpec((b,), torch.float32)}
    bspec = {"sparse_ids": P(dp, None), "dense": P(dp, None), "labels": P(dp)}
    return make_recsys_cell(
        name="autoint", shape=shape, mesh=mesh, params_sh=params_sh, pspec=pspec,
        loss=lambda p, bt: R.autoint_loss(p, bt, cfg),
        forward=lambda p, bt: R.autoint_forward(p, bt, cfg),
        batch_sds=batch_sds, batch_spec=bspec, model_flops=_flops(cfg, b),
        notes="retrieval_cand = offline scoring sweep of 1M rows" if
              shape.name == "retrieval_cand" else "")


register(ArchDef(
    name="autoint", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES, build_cell=build_cell,
))
