"""The paper's own workload proxy: a small MLP classifier used by the
decentralized-learning experiments (Sec. 6.2 on synthetic
Dirichlet-heterogeneous data) — a copy of ``repro/configs/paper_mlp.py``."""
from dataclasses import dataclass


@dataclass(frozen=True)
class MLPConfig:
    name: str = "paper-mlp"
    family: str = "mlp"
    input_dim: int = 64
    hidden: tuple = (128, 128)
    num_classes: int = 10
    source: str = "paper Sec. 6.2 (LeNet/VGG proxy)"


CONFIG = MLPConfig()
