"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

[hf:databricks/dbrx-base] 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16e top-4.
"""
from .base import MOE, ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    arch_type=MOE,
    num_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    n_experts=16,
    top_k=4,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                        d_ff=256, vocab_size=512, n_experts=4, top_k=2,
                        sliding_window=64)
