"""phi3-medium-14b [arXiv:2404.14219]: 40L d5120 40H (GQA kv=10) d_ff17920,
RoPE + SwiGLU.  Full attention -> long_500k skipped."""
import torch

from repro_torch.models.transformer import AttentionConfig, LMConfig
from .lm_common import register_lm

FULL = LMConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, vocab_size=100_352, d_ff=17920,
    attn=AttentionConfig("gqa", n_heads=40, n_kv=10, d_head=128),
    q_chunk=2048, dtype=torch.bfloat16,
)

REDUCED = LMConfig(
    name="phi3-medium-14b-smoke",
    n_layers=2, d_model=64, vocab_size=512, d_ff=192,
    attn=AttentionConfig("gqa", n_heads=4, n_kv=2, d_head=16),
    dtype=torch.float32, remat=False,
)

register_lm("phi3-medium-14b", FULL, REDUCED, long_ok=False)
