"""minitron-8b [dense] — pruned nemotron.

[arXiv:2407.14679] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    arch_type=DENSE,
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=256_000,
    source="arXiv:2407.14679",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
