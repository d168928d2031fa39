"""The federation (client) axis sharded over a ``torch.distributed`` group.

Counterpart of ``repro/fed/sharding.py``.  The reference shards the
engine's client-slot axis over the ``'data'`` axis of a device mesh; here
each rank of a process group owns ``capacity / n_shards`` whole slots:

  * every rank runs the same scheduler on the same host RNG, so every
    rank holds the same full plan, ``s`` and scheme coefficients;
  * the engine's data buffers hold only the rank's own slots
    (``slots``), and ``shard`` cuts the rank's share of every client-axis
    tensor of a round (alpha, batch indices, coefficients); the batch
    indices are cut on the host, before they go up;
  * each rank trains its own clients, reduces its slab with one local
    kernel launch, and ``all_reduce`` sums the (D,) partials, which leaves
    the params replicated.

Capacity is padded to whole slots per rank (``pad_capacity``): the extra
slots are ordinary empty capacity slots (p = 0, they never train).

The caller initialises the process group and chooses its backend (NCCL
for CUDA tensors, gloo for CPU tensors); nothing here picks one::

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=n)
    fs = make_fed_sharding()
    FederatedTrainer(..., engine="plan", sharding=fs)

Composite federation axes, model-sharded params and GSPMD placement
(``client_spec``, ``put_*``, ``param_sharding``) have no counterpart yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class FedSharding:
    """This rank's place on the federation axis: ``n_shards`` ranks of
    ``group`` (None: the default group), this one ``rank``."""
    n_shards: int
    rank: int
    group: Optional[Any] = None

    def __post_init__(self):
        if not 0 <= self.rank < self.n_shards:
            raise ValueError(f"rank {self.rank} outside the federation "
                             f"axis of {self.n_shards} shards")

    def pad_capacity(self, capacity: int) -> int:
        """Round capacity up so every shard owns the same number of whole
        slots (padded slots behave exactly like empty capacity slots)."""
        n = self.n_shards
        return -(-capacity // n) * n

    def slots(self, capacity: int) -> range:
        """The slots this rank owns out of a padded ``capacity``."""
        per = self._per_shard(capacity)
        return range(self.rank * per, (self.rank + 1) * per)

    def shard(self, x):
        """This rank's share of a client-axis tensor or host array (client
        axis first): its rows (slots), as a view."""
        per = self._per_shard(x.shape[0])
        return x[self.rank * per:(self.rank + 1) * per]

    def _per_shard(self, K: int) -> int:
        if K % self.n_shards:
            raise ValueError(
                f"client axis {K} not divisible by the federation axis of "
                f"{self.n_shards} shards; pad the client axis "
                f"(FedSharding.pad_capacity)")
        return K // self.n_shards

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the federation axis, in place; returns it.  A
        CUDA tensor needs an NCCL group: no other backend is taken in its
        place."""
        backend = dist.get_backend(self.group)
        if t.is_cuda and "nccl" not in backend:
            raise ValueError(f"a CUDA tensor's all-reduce needs an NCCL "
                             f"process group, got backend {backend!r}")
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def make_fed_sharding(group=None) -> FedSharding:
    """FedSharding over the ranks of ``group`` (None: the default group),
    which the caller has initialised with ``dist.init_process_group``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_fed_sharding needs an initialised "
                           "torch.distributed process group: call "
                           "dist.init_process_group(...) first")
    return FedSharding(n_shards=dist.get_world_size(group),
                       rank=dist.get_rank(group), group=group)
