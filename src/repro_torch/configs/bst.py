"""bst [arXiv:1905.06874]: Behavior Sequence Transformer -- embed_dim 32, seq 20,
1 transformer block, 8 heads, MLP 1024-512-256."""
from __future__ import annotations

from repro_torch.models import recsys as R
from .base import ArchDef, register
from .recsys_common import SHAPES

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


register(ArchDef(
    name="bst", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES,
    notes="user-behavior sequences ARE token sequences: SUFFIX-sigma computes their "
          "n-gram statistics unchanged (DESIGN.md SSArch-applicability)",
))
