"""The paper's own experiment models (Section 5.1).

Copy of the reference's ``configs/paper.py``: the MNIST 2-layer MLP and the
EMNIST 2-conv CNN (both per McMahan et al. 2016), and logistic regression
for SYNTHETIC(alpha, beta) (Li et al. 2018).  The reference's ``fed``
field (a ``FedConfig`` that nothing on the federated round reads) is left
out; scheme, epochs and learning rate are the trainer's arguments.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperModelConfig:
    name: str
    kind: str                 # mlp | cnn | logreg
    input_shape: tuple
    n_classes: int
    hidden: int = 200
    eta0: float = 2e-3
    batch_size: int = 10
    n_devices: int = 100      # federated clients in the paper's experiments
    local_epochs: int = 5


MNIST_MLP = PaperModelConfig(
    name="mnist_mlp",
    kind="mlp",
    input_shape=(28, 28),
    n_classes=10,
    hidden=200,
    eta0=2e-3,
    batch_size=10,
    n_devices=100,
)

EMNIST_CNN = PaperModelConfig(
    name="emnist_cnn",
    kind="cnn",
    input_shape=(28, 28, 1),
    n_classes=62,
    eta0=5e-4,
    batch_size=10,
    n_devices=62,
)

SYNTHETIC_LR = PaperModelConfig(
    name="synthetic_lr",
    kind="logreg",
    input_shape=(60,),
    n_classes=10,
    eta0=1.0,
    batch_size=20,
    n_devices=50,
)

PAPER_CONFIGS = {
    "mnist_mlp": MNIST_MLP,
    "emnist_cnn": EMNIST_CNN,
    "synthetic_lr": SYNTHETIC_LR,
}
