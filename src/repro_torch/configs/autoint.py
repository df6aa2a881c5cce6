"""autoint [arXiv:1810.11921]: 39 sparse fields, embed 16, 3 self-attention
interaction layers (2 heads, d_attn 32)."""
from __future__ import annotations

from repro_torch.models import recsys as R
from .base import ArchDef, register
from .recsys_common import SHAPES

FULL = R.AutoIntConfig(n_sparse=39, field_vocab=1_000_000, embed_dim=16,
                       n_attn_layers=3, n_heads=2, d_attn=32)
REDUCED = R.AutoIntConfig(n_sparse=5, field_vocab=200, embed_dim=8,
                          n_attn_layers=2, d_attn=8)


def _flops(cfg: R.AutoIntConfig, batch: int) -> float:
    f = cfg.n_sparse + 1
    per_layer = 3 * 2 * f * cfg.embed_dim * cfg.d_attn + 2 * f * f * cfg.d_attn * 2
    return float(batch * (cfg.n_attn_layers * per_layer + 2 * f * cfg.d_attn))


register(ArchDef(
    name="autoint", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES,
))
