"""Config registry of the port: ``--arch <id>`` resolution, the same ids,
full configs and smoke configs as the JAX package's ``configs``."""
from . import femnist_cnn
from .base import (  # noqa: F401
    AUDIO,
    DENSE,
    HYBRID,
    INPUT_SHAPES,
    MOE,
    SSM,
    VLM,
    VOCAB_PAD,
    ArchConfig,
    InputShape,
    pad_vocab,
)

from . import (  # noqa: E402
    dbrx_132b,
    deepseek_v2_236b,
    granite_3_2b,
    granite_8b,
    internvl2_26b,
    mamba2_780m,
    minitron_8b,
    qwen15_4b,
    whisper_large_v3,
    zamba2_7b,
)

_MODULES = {
    "deepseek-v2-236b": deepseek_v2_236b,
    "internvl2-26b": internvl2_26b,
    "granite-8b": granite_8b,
    "minitron-8b": minitron_8b,
    "granite-3-2b": granite_3_2b,
    "whisper-large-v3": whisper_large_v3,
    "qwen1.5-4b": qwen15_4b,
    "zamba2-7b": zamba2_7b,
    "mamba2-780m": mamba2_780m,
    "dbrx-132b": dbrx_132b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ArchConfig:
    """Full-size config for ``--arch <id>``."""
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family variant for CPU smoke runs."""
    return _MODULES[arch].smoke_config()

