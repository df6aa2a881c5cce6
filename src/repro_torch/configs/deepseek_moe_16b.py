"""deepseek-moe-16b [arXiv:2401.06066]: 28L d2048 16H(kv16) fine-grained MoE --
64 routed experts (d_ff 1408) top-6 + 2 shared experts.  GQA full attention ->
long_500k skipped."""
import torch

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import AttentionConfig, LMConfig
from .lm_common import register_lm

FULL = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, vocab_size=102_400, d_ff=1408,
    attn=AttentionConfig("gqa", n_heads=16, n_kv=16, d_head=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared=2, d_ff_shared=2816, capacity_factor=1.25),
    q_chunk=2048, dtype=torch.bfloat16,
)

REDUCED = LMConfig(
    name="deepseek-moe-16b-smoke",
    n_layers=2, d_model=64, vocab_size=512, d_ff=128,
    attn=AttentionConfig("gqa", n_heads=4, n_kv=4, d_head=16),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                  d_ff_shared=64, capacity_factor=2.0),
    dtype=torch.float32, remat=False,
)

register_lm("deepseek-moe-16b", FULL, REDUCED, long_ok=False,
            notes="EP dispatch shares the n-gram shuffle substrate (DESIGN.md SS4)")
