"""xdeepfm [arXiv:1803.05170]: CIN 200-200-200 + DNN 400-400 over 39 sparse fields,
embed 10."""
from __future__ import annotations

import torch

from repro_torch.models import recsys as R
from .base import P, ArchDef, ShapeDef, TensorSpec, register, replicated, shard_if
from .recsys_common import SHAPES, dp_spec, make_recsys_cell, param_specs

FULL = R.XDeepFMConfig(n_sparse=39, field_vocab=1_000_000, embed_dim=10,
                       cin_layers=(200, 200, 200), mlp_dims=(400, 400))
REDUCED = R.XDeepFMConfig(n_sparse=5, field_vocab=200, embed_dim=8,
                          cin_layers=(8, 8), mlp_dims=(16,))


def _flops(cfg: R.XDeepFMConfig, batch: int) -> float:
    f, d = cfg.n_sparse, cfg.embed_dim
    cin = 0
    h_prev = f
    for h in cfg.cin_layers:
        cin += h_prev * f * d + 2 * h * h_prev * f * d   # outer product + compress
        h_prev = h
    dims = (f * d + cfg.n_dense,) + cfg.mlp_dims + (1,)
    deep = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return float(batch * (cin + deep))


def build_cell(cfg_factory, shape: ShapeDef, mesh):
    cfg = FULL
    params_sh = param_specs(R.xdeepfm_init, cfg)
    pspec = replicated(params_sh)
    pspec["tables"] = P(None, shard_if(mesh, cfg.field_vocab, "model"), None)
    pspec["linear"] = P(None, shard_if(mesh, cfg.field_vocab, "model"))
    b = shape.dims.get("n_candidates", shape.dims["batch"])
    dp = dp_spec(mesh)
    batch_sds = {"sparse_ids": TensorSpec((b, cfg.n_sparse), torch.int32),
                 "dense": TensorSpec((b, cfg.n_dense), torch.float32),
                 "labels": TensorSpec((b,), torch.float32)}
    bspec = {"sparse_ids": P(dp, None), "dense": P(dp, None), "labels": P(dp)}
    return make_recsys_cell(
        name="xdeepfm", shape=shape, mesh=mesh, params_sh=params_sh, pspec=pspec,
        loss=lambda p, bt: R.xdeepfm_loss(p, bt, cfg),
        forward=lambda p, bt: R.xdeepfm_forward(p, bt, cfg),
        batch_sds=batch_sds, batch_spec=bspec, model_flops=_flops(cfg, b))


register(ArchDef(
    name="xdeepfm", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES, build_cell=build_cell,
))
