"""qwen1.5-4b [dense] — QKV bias.

[hf:Qwen/Qwen1.5-0.5B] 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936.
"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    arch_type=DENSE,
    num_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
