"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

[arXiv:2405.04434] 60L d_model=5120 128H (GQA kv=128) d_ff=1536 vocab=102400.
"""
from .base import MOE, ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    arch_type=MOE,
    num_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=1536,                # per-expert FFN width
    vocab_size=102_400,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    kv_lora_rank=512,         # MLA compressed KV
    rope_head_dim=64,
    source="arXiv:2405.04434",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
                        d_head=32, d_ff=128, vocab_size=512, n_experts=4,
                        n_shared_experts=1, top_k=2, kv_lora_rank=64,
                        rope_head_dim=16, sliding_window=64)
