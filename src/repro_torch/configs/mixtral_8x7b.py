"""mixtral-8x7b [arXiv:2401.04088]: 32L d4096 32H(kv8) d_ff14336, 8 experts top-2,
sliding-window attention (4096) -> the one LM arch that runs long_500k (window-
bounded cache = sub-quadratic)."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import AttentionConfig, LMConfig
from .lm_common import register_lm

FULL = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, vocab_size=32_000, d_ff=14336,
    attn=AttentionConfig("gqa", n_heads=32, n_kv=8, d_head=128, window=4096),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, capacity_factor=1.25),
    q_chunk=2048, dtype=torch.bfloat16,
)

REDUCED = LMConfig(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=64, vocab_size=512, d_ff=128,
    attn=AttentionConfig("gqa", n_heads=4, n_kv=2, d_head=16, window=8),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=2.0),
    dtype=torch.float32, remat=False,
)

register_lm("mixtral-8x7b", FULL, REDUCED, long_ok=True,
            notes="SWA window 4096 bounds the long_500k decode cache")
