"""llama3.2-1b [hf:meta-llama/Llama-3.2-1B]: 16L d2048 32H (GQA kv=8) d_ff8192,
vocab 128256.  Full attention -> long_500k skipped."""
import torch

from repro_torch.models.transformer import AttentionConfig, LMConfig
from .lm_common import register_lm

FULL = LMConfig(
    name="llama3.2-1b",
    n_layers=16, d_model=2048, vocab_size=128_256, d_ff=8192,
    attn=AttentionConfig("gqa", n_heads=32, n_kv=8, d_head=64, rope_theta=500_000.0),
    q_chunk=2048, dtype=torch.bfloat16,
)

REDUCED = LMConfig(
    name="llama3.2-1b-smoke",
    n_layers=2, d_model=64, vocab_size=512, d_ff=128,
    attn=AttentionConfig("gqa", n_heads=4, n_kv=2, d_head=16),
    dtype=torch.float32, remat=False,
)

register_lm("llama3.2-1b", FULL, REDUCED, long_ok=False)
