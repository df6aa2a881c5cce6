"""xdeepfm [arXiv:1803.05170]: CIN 200-200-200 + DNN 400-400 over 39 sparse fields,
embed 10."""
from __future__ import annotations

from repro_torch.models import recsys as R
from .base import ArchDef, register
from .recsys_common import SHAPES

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


register(ArchDef(
    name="xdeepfm", family="recsys",
    make=lambda: FULL, make_reduced=lambda: REDUCED,
    shapes=SHAPES,
))
