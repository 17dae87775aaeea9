"""granite-3-2b [dense] — GQA.

[hf:ibm-granite/granite-3.0-2b-base] 40L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=49155.
"""
from .base import DENSE, ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    arch_type=DENSE,
    num_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49_155,        # padded to 49408 by pad_vocab
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
