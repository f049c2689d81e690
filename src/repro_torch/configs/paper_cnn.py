"""The paper's own experimental model: 2-block CIFAR-10 CNN (Section IV-A).

Conv2D 5x5x32 -> Conv2D 32 -> maxpool 2x2 -> Conv2D 5x5x64 -> Conv2D 64
-> maxpool 2x2 -> Dense 1024x512 -> Dense 512 -> Dense 512x10.
Adopted from FedAvg / FedPSO / FedGWO / FedSCA for comparability.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    image_size: int = 32
    channels: int = 3
    conv1_filters: int = 32
    conv2_filters: int = 64
    kernel: int = 5
    dense_hidden: int = 512
    num_classes: int = 10
    dropout: float = 0.2


CONFIG = CNNConfig()
