"""granite-8b [dense] — llama-arch code model.

[arXiv:2405.04324] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    arch_type=DENSE,
    num_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    source="arXiv:2405.04324",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
