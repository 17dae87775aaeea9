"""The paper's own model (§VII.A): 4-layer CNN for FEMNIST OCR.

[Conv2D(32), MaxPool, Conv2D(64), MaxPool, Dense(2048), Dense(62)] —
lightweight, suitable for resource-constrained industrial devices.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "femnist-cnn"
    image_size: int = 28
    channels: tuple = (32, 64)
    kernel: int = 5
    hidden: int = 2048
    num_classes: int = 62
    source: str = "paper §VII.A (LEAF FEMNIST CNN)"


CONFIG = CNNConfig()


def smoke_config() -> CNNConfig:
    return dataclasses.replace(CONFIG, channels=(8, 16), hidden=128)
