"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060] 48L d_model=1536 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.
"""
from .base import SSM, ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    arch_type=SSM,
    num_layers=48,
    d_model=1536,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,        # padded to 50432 by pad_vocab
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    source="arXiv:2405.21060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, vocab_size=512,
                        ssm_state=16, ssm_head_dim=32)
