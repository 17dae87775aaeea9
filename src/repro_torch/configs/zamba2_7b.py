"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242] 81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
ssm_state=64. The shared attention block's weights are reused every
``attn_every`` layers (Zamba's weight-sharing trick).
"""
from .base import HYBRID, ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    arch_type=HYBRID,
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, ssm_state=16,
                        ssm_head_dim=32, attn_every=2, sliding_window=64)
