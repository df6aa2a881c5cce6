"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: 62L d2560 40H dense LM with MLA
(multi-head latent attention; q_lora 768, kv_lora 256, nope 64 / rope 32 / v 64).
Decode uses the absorbed latent cache.  Full attention -> long_500k skipped."""
import torch

from repro_torch.models.transformer import AttentionConfig, LMConfig
from .lm_common import register_lm

FULL = LMConfig(
    name="minicpm3-4b",
    n_layers=62, d_model=2560, vocab_size=73_448, d_ff=6400,
    attn=AttentionConfig("mla", n_heads=40, n_kv=40, d_head=96,
                         q_lora=768, kv_lora=256, d_nope=64, d_rope=32, d_v=64),
    q_chunk=2048, dtype=torch.bfloat16,
)

REDUCED = LMConfig(
    name="minicpm3-4b-smoke",
    n_layers=2, d_model=64, vocab_size=512, d_ff=128,
    attn=AttentionConfig("mla", n_heads=4, n_kv=4, d_head=24,
                         q_lora=32, kv_lora=16, d_nope=16, d_rope=8, d_v=16),
    dtype=torch.float32, remat=False,
)

register_lm("minicpm3-4b", FULL, REDUCED, long_ok=False,
            notes="MLA latent cache: decode caches rank-256 ckv + rope key only")
