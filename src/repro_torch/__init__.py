"""PyTorch/CUDA port of the flexible-participation federated learning system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``configs/``, ``data/``, ``kernels/``, ``models/``, ``fed/``,
``checkpoint/``) so each module has one counterpart to be held against,
and its checkpoints are the reference's files.  It imports neither
``jax`` nor anything of ``repro``: what it needs of the reference's
numpy-only modules it keeps as its own copy.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`resolve_device`).  The kernels of the
federated round, ``weighted_agg``, ``masked_sgd`` and, on the int8 wires,
``weighted_agg_quant``, the prefill attention of LM serving,
``flash_attention``, and the intra-chunk term of Mamba2's SSD prefill,
``ssd_intra_chunk``, are hand-written CUDA for ``sm_90a``
(``kernels/csrc/``), built with ``nvcc`` at their first launch; CPU
tensors take their plain PyTorch versions.  ``make_fed_sharding`` shards
the federation's client axis over an initialised ``torch.distributed``
group (``fed/sharding.py``), whose ranks reduce their clients' deltas with
the same kernels and all-reduce the partial sums.
"""
from repro_torch.device import resolve_device
from repro_torch.fed.sharding import FedSharding, make_fed_sharding

__all__ = ["resolve_device", "FedSharding", "make_fed_sharding"]
