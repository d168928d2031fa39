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

Over a process grid (``launch.mesh``; ``FedSharding(mesh=, axis=)``,
``make_fed_sharding(mesh=, axis=)``) the federation axis is one of the
grid's axes or the composite ``('pod', 'data')``, whose shards are the
product of the two, and the group is this rank's along it.  Axes the
federation does not name (``model``) are left to the params: each leaf
stays cut over them by the model's rule table (``param_sharding``,
``put_params``), every rank of a model row trains the same slots on its
own shards, and the all-reduce over the federation axis sums each shard's
deltas apart: the params stay sharded over ``model``.

The caller initialises the process group and chooses its backend (NCCL
for CUDA tensors, gloo for CPU tensors); nothing here picks one::

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=n)
    fs = make_fed_sharding()
    FederatedTrainer(..., engine="plan", sharding=fs)

The reference's placement and constraints (``put_*``, ``constrain_*``)
steer GSPMD; here a tensor is the rank's own, so ``put_params`` cuts the
rank's shards of full params and ``constrain_params`` checks a tree's
shards against their layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.models.sharding import (_entry_axes, _filter_spec,
                                         leaf_index, local_shape, take)


@dataclass(frozen=True)
class FedSharding:
    """This rank's place on the federation axis: ``n_shards`` ranks of
    ``group`` (None: the default group), this one ``rank``; or, given a
    grid ``mesh``, the grid's federation ``axis`` (a name, or a tuple such
    as ``('pod', 'data')``), which fixes all three."""
    n_shards: Optional[int] = None
    rank: Optional[int] = None
    group: Optional[Any] = None
    mesh: Optional[Any] = None
    axis: Union[str, Tuple[str, ...]] = "data"

    def __post_init__(self):
        if self.mesh is not None:
            for a in self.axes:
                if a not in self.mesh.axis_names:
                    raise ValueError(
                        f"mesh has no {a!r} axis (axes: "
                        f"{self.mesh.axis_names}); every federation axis "
                        f"must name an existing mesh axis")
            object.__setattr__(self, "n_shards",
                               self.mesh.axis_size(self.axes))
            object.__setattr__(self, "rank", self.mesh.coord(self.axes))
            object.__setattr__(self, "group", self.mesh.group(self.axes))
        if self.n_shards is None or self.rank is None:
            raise ValueError("FedSharding needs n_shards= and rank=, or "
                             "mesh=")
        if not 0 <= self.rank < self.n_shards:
            raise ValueError(f"rank {self.rank} outside the federation "
                             f"axis of {self.n_shards} shards")

    # -- geometry -------------------------------------------------------------
    @property
    def axes(self) -> Tuple[str, ...]:
        """The federation axis names as a tuple (composite-safe form)."""
        return (self.axis,) if isinstance(self.axis, str) else \
            tuple(self.axis)

    @property
    def model_ranks(self) -> int:
        """Ranks of the grid's model axis (1 without one)."""
        if self.mesh is None or "model" not in self.mesh.axis_names:
            return 1
        return self.mesh.shape["model"]

    # -- specs ----------------------------------------------------------------
    def _entry(self):
        """The spec entry for the client dim: the bare name for a single
        axis, the tuple for a composite one."""
        return self.axis if isinstance(self.axis, str) else tuple(self.axis)

    def client_spec(self, ndim: int, axis_dim: int = 0) -> Tuple:
        """The spec sharding dimension ``axis_dim`` over the federation
        axis/axes (the slot axis of engine buffers; plan arrays carry the
        client axis at dim 1)."""
        spec = [None] * ndim
        spec[axis_dim] = self._entry()
        return tuple(spec)

    def param_sharding(self, spec: Optional[Tuple]) -> Tuple:
        """A parameter leaf's spec on this grid: None replicates (``()``);
        a spec of the rule table (``models.sharding.tree_param_specs``)
        keeps the axes the grid has and drops the others, so one spec
        serves every grid shape."""
        if spec is None:
            return ()
        if self.mesh is None:
            return (None,) * len(spec)
        return _filter_spec(spec, self.mesh)

    def _cut(self, spec) -> Dict[str, int]:
        """The grid axes a leaf's spec cuts it over (model only: FSDP over
        the federation axes is not the port's yet)."""
        if self.mesh is None:
            return {}
        axes = {a for e in spec for a in _entry_axes(e)}
        fed = axes & set(self.axes)
        if fed:
            raise NotImplementedError(
                f"params sharded over the federation axes {sorted(fed)} "
                f"(FSDP): the client-sequential round under sharding is "
                f"ROADMAP item 6's next step")
        return {a: self.mesh.shape[a] for a in axes}

    # -- placement: this rank's shards ----------------------------------------
    def put_params(self, tree, specs=None, *, cfg=None, full=None):
        """This rank's shards of a flat dict of full leaves: each leaf cut
        by its spec over the grid's model axis (``cfg``'s layout, the
        KV-head copies and conv channels included).  specs None: the tree
        as it is (replicated).  ``full`` ({name: full shape}): leaves
        already at their shard's shape pass as they are."""
        if specs is None or self.model_ranks == 1:
            return tree
        out = {}
        for name, leaf in tree.items():
            spec = self.param_sharding(specs[name])
            sizes = self._cut(spec)
            if not sizes:
                out[name] = leaf
                continue
            shape = tuple(full[name]) if full is not None else \
                tuple(leaf.shape)
            if full is not None and tuple(leaf.shape) != shape:
                out[name] = self._check(name, leaf, shape, spec, cfg, sizes)
                continue
            out[name] = take(leaf, leaf_index(
                name, shape, spec, cfg, sizes,
                {a: self.mesh.coord(a) for a in sizes}))
        return out

    def _check(self, name, leaf, shape, spec, cfg, sizes):
        want = local_shape(name, shape, spec, cfg, sizes)
        if tuple(leaf.shape) != want:
            raise ValueError(f"{name}: a leaf of {tuple(leaf.shape)} is "
                             f"neither the full {shape} nor this rank's "
                             f"shard {want}")
        return leaf

    def constrain_params(self, tree, specs=None, *, cfg=None, full=None):
        """Check that every leaf of a flat dict is this rank's shard of
        its full shape in ``full``; returns the tree.  specs None: leaves
        must be whole."""
        for name, leaf in tree.items():
            shape = tuple(full[name])
            spec = self.param_sharding(None if specs is None
                                       else specs[name]) or \
                (None,) * len(shape)
            self._check(name, leaf, shape, spec, cfg, self._cut(spec))
        return tree

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


def make_fed_sharding(group=None, *, mesh=None,
                      axis: Union[str, Tuple[str, ...]] = "data"
                      ) -> FedSharding:
    """FedSharding over the ranks of ``group`` (None: the default group),
    which the caller has initialised with ``dist.init_process_group``; or
    over the federation ``axis`` of a grid ``mesh`` (``launch.mesh``;
    ``axis=('pod', 'data')`` for a composite multi-pod federation)."""
    if mesh is not None:
        return FedSharding(mesh=mesh, axis=axis)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_fed_sharding needs an initialised "
                           "torch.distributed process group: call "
                           "dist.init_process_group(...) first")
    return FedSharding(n_shards=dist.get_world_size(group),
                       rank=dist.get_rank(group), group=group)
