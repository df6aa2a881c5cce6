"""two-tower-retrieval [YouTube, RecSys'19]: embed 256, towers 1024-512-256,
dot-product scoring, in-batch sampled softmax; retrieval_cand is the real serving
shape (1 query x 1M candidates, batched dot)."""
from __future__ import annotations

import torch

from repro_torch.models import recsys as R
from .base import P, ArchDef, ShapeDef, TensorSpec, register, replicated, shard_if
from .recsys_common import SHAPES, dp_spec, make_recsys_cell, param_specs

FULL = R.TwoTowerConfig(item_vocab=10_000_000, embed_dim=256, user_feat=256,
                        tower_dims=(1024, 512, 256))
REDUCED = R.TwoTowerConfig(item_vocab=500, embed_dim=16, user_feat=16,
                           tower_dims=(32, 16))


def _tower_flops(cfg, n, d_in):
    dims = (d_in,) + cfg.tower_dims
    return n * sum(2 * a * b for a, b in zip(dims, dims[1:]))


def _flops(cfg: R.TwoTowerConfig, batch: int) -> float:
    """Both towers and the in-batch logits of ``batch`` rows (``repro``'s
    train and serve cells)."""
    return float(_tower_flops(cfg, batch, cfg.user_feat)
                 + _tower_flops(cfg, batch, cfg.embed_dim)
                 + 2 * batch * batch * cfg.tower_dims[-1])


def _retrieval_flops(cfg: R.TwoTowerConfig, n: int) -> float:
    """The item tower over ``n`` candidates and their dot products with one
    query (``repro``'s retrieval_cand cell)."""
    return float(_tower_flops(cfg, n, cfg.embed_dim) + 2 * n * cfg.tower_dims[-1])


def build_cell(cfg_factory, shape: ShapeDef, mesh):
    cfg = FULL
    params_sh = param_specs(R.twotower_init, cfg)
    pspec = replicated(params_sh)
    pspec["item_embed"] = P(shard_if(mesh, cfg.item_vocab, "model"), None)
    dp = dp_spec(mesh)
    if shape.name == "retrieval_cand":
        n = shape.dims["n_candidates"]
        batch_sds = {"user": TensorSpec((1, cfg.user_feat), torch.float32),
                     "candidates": TensorSpec((n,), torch.int32)}
        bspec = {"user": P(None, None), "candidates": P(dp)}
        return make_recsys_cell(
            name="two-tower-retrieval", shape=shape, mesh=mesh, params_sh=params_sh,
            pspec=pspec, loss=None,
            forward=lambda p, bt: R.twotower_score_candidates(p, bt, cfg),
            batch_sds=batch_sds, batch_spec=bspec,
            model_flops=_retrieval_flops(cfg, n))
    b = shape.dims["batch"]
    batch_sds = {"user": TensorSpec((b, cfg.user_feat), torch.float32),
                 "pos_item": TensorSpec((b,), torch.int32)}
    bspec = {"user": P(dp, None), "pos_item": P(dp)}
    if shape.kind == "train":
        return make_recsys_cell(
            name="two-tower-retrieval", shape=shape, mesh=mesh, params_sh=params_sh,
            pspec=pspec, loss=lambda p, bt: R.twotower_loss(p, bt, cfg),
            forward=None, batch_sds=batch_sds, batch_spec=bspec,
            model_flops=_flops(cfg, b))
    return make_recsys_cell(
        name="two-tower-retrieval", shape=shape, mesh=mesh, params_sh=params_sh,
        pspec=pspec, loss=None,
        forward=lambda p, bt: R.twotower_embed(p, bt, cfg),
        batch_sds=batch_sds, batch_spec=bspec, model_flops=_flops(cfg, b))


register(ArchDef(
    name="two-tower-retrieval", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES, build_cell=build_cell,
    notes="negative-sampling frequencies come from the degenerate sigma=1 "
          "SUFFIX-sigma job (distributed item counting)",
))
