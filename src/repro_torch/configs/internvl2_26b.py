"""internvl2-26b [vlm] — InternViT + InternLM2; ViT is a stub frontend.

[arXiv:2404.16821] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
"""
from .base import VLM, ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    arch_type=VLM,
    num_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,        # padded to 92672 by pad_vocab
    vision_prefix_frac=0.125,  # 1/8 of the sequence is patch embeddings
    source="arXiv:2404.16821",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_(num_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
                        d_ff=512, vocab_size=512, sliding_window=64)
