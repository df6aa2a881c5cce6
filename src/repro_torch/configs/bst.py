"""bst [arXiv:1905.06874]: Behavior Sequence Transformer -- embed_dim 32, seq 20,
1 transformer block, 8 heads, MLP 1024-512-256."""
from __future__ import annotations

import torch

from repro_torch.models import recsys as R
from .base import P, ArchDef, ShapeDef, TensorSpec, register, replicated, shard_if
from .recsys_common import SHAPES, dp_spec, make_recsys_cell, param_specs

FULL = R.BSTConfig(item_vocab=4_000_000, embed_dim=32, seq_len=20, n_blocks=1,
                   n_heads=8, mlp_dims=(1024, 512, 256))
REDUCED = R.BSTConfig(item_vocab=500, embed_dim=8, seq_len=6, n_blocks=1,
                      n_heads=2, mlp_dims=(32, 16))


def _flops(cfg: R.BSTConfig, batch: int) -> float:
    d, s = cfg.embed_dim, cfg.seq_len + 1
    attn = cfg.n_blocks * (4 * s * d * d + 2 * s * s * d + 8 * s * d * d)
    dims = (s * d,) + cfg.mlp_dims + (1,)
    m = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return float(batch * (attn + m))


def build_cell(cfg_factory, shape: ShapeDef, mesh):
    cfg = FULL
    params_sh = param_specs(R.bst_init, cfg)
    pspec = replicated(params_sh)
    pspec["item_embed"] = P(shard_if(mesh, cfg.item_vocab, "model"), None)
    pspec["mlp"] = [(P(None, shard_if(mesh, w.shape[1], "model")), P(None))
                    for (w, b) in params_sh["mlp"]]
    b = shape.dims.get("n_candidates", shape.dims["batch"])
    dp = dp_spec(mesh)
    batch_sds = {"history": TensorSpec((b, cfg.seq_len), torch.int32),
                 "target": TensorSpec((b,), torch.int32),
                 "labels": TensorSpec((b,), torch.float32)}
    bspec = {"history": P(dp, None), "target": P(dp), "labels": P(dp)}
    if shape.name == "retrieval_cand":  # one user, 1M candidate targets
        batch_sds.pop("labels"), bspec.pop("labels")
        fwd = lambda p, bt: R.bst_forward(p, {**bt, "labels": None}, cfg)  # noqa: E731
    else:
        fwd = lambda p, bt: R.bst_forward(p, bt, cfg)  # noqa: E731
    return make_recsys_cell(
        name="bst", shape=shape, mesh=mesh, params_sh=params_sh, pspec=pspec,
        loss=lambda p, bt: R.bst_loss(p, bt, cfg), forward=fwd,
        batch_sds=batch_sds, batch_spec=bspec, model_flops=_flops(cfg, b))


register(ArchDef(
    name="bst", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES, build_cell=build_cell,
    notes="user-behavior sequences ARE token sequences: SUFFIX-sigma computes their "
          "n-gram statistics unchanged (DESIGN.md SSArch-applicability)",
))
