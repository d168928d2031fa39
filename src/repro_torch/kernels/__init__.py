"""The port's hand-written CUDA kernels (``csrc/``), their plain PyTorch
versions and the wrappers that choose between them (``ops``)."""
