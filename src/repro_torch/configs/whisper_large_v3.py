"""whisper-large-v3 [audio] — enc-dec; conv/mel frontend is a stub
(``input_specs`` provides precomputed frame embeddings).

[arXiv:2212.04356] 32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.
"""
from .base import AUDIO, ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    arch_type=AUDIO,
    num_layers=32,            # 32 encoder + 32 decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,        # padded to 52224 by pad_vocab
    is_encoder_decoder=True,
    gated_mlp=False,          # whisper uses a plain GELU MLP
    source="arXiv:2212.04356",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
