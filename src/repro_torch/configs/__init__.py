from repro_torch.configs.base import PORTED_IDS, ArchConfig, get_config
from repro_torch.configs.paper import (EMNIST_CNN, MNIST_MLP, PAPER_CONFIGS,
                                      SYNTHETIC_LR, PaperModelConfig)

__all__ = ["PaperModelConfig", "MNIST_MLP", "EMNIST_CNN", "SYNTHETIC_LR",
           "PAPER_CONFIGS", "ArchConfig", "PORTED_IDS",
           "get_config"]
