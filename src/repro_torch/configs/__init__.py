from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, PAPER_IDS,
                                      PORTED_IDS, ArchConfig, FedConfig,
                                      InputShape, all_configs, get_config)
from repro_torch.configs.paper import (EMNIST_CNN, MNIST_MLP, PAPER_CONFIGS,
                                      SYNTHETIC_LR, PaperModelConfig)

__all__ = ["PaperModelConfig", "MNIST_MLP", "EMNIST_CNN", "SYNTHETIC_LR",
           "PAPER_CONFIGS", "ARCH_IDS", "PAPER_IDS", "INPUT_SHAPES",
           "ArchConfig", "FedConfig", "InputShape", "PORTED_IDS",
           "all_configs", "get_config"]
