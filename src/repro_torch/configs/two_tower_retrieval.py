"""two-tower-retrieval [YouTube, RecSys'19]: embed 256, towers 1024-512-256,
dot-product scoring, in-batch sampled softmax; retrieval_cand is the real serving
shape (1 query x 1M candidates, batched dot)."""
from __future__ import annotations

from repro_torch.models import recsys as R
from .base import ArchDef, register
from .recsys_common import SHAPES

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


register(ArchDef(
    name="two-tower-retrieval", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES,
    notes="negative-sampling frequencies come from the degenerate sigma=1 "
          "SUFFIX-sigma job (distributed item counting)",
))
