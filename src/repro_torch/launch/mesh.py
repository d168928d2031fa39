"""Process grids: the port's meshes, counterpart of ``repro/launch/mesh.py``.

The reference lays a named ``jax.sharding.Mesh`` over its devices; here a
``Grid`` names the axes of the ranks of an initialised
``torch.distributed`` world, one process per rank, and holds the
``torch.distributed`` group of every axis (and of the composite
federation axis ``('pod', 'data')``) that contains this rank:

  pod    -- multi-pod federation (outermost)
  data   -- the federation's client axis (``fed.sharding.FedSharding``)
  model  -- tensor and expert parallelism (``models.sharding``)

Ranks are laid out row-major over the axes, ``model`` innermost, as the
reference's device order: on (data 2, model 2) ranks 0 and 1 are the
model axis of data coordinate 0.

The groups come from ``dist.new_subgroups_by_enumeration``, called for
every axis on every rank in one order, rather than from
``init_device_mesh``: an axis may need its own backend.  One card cannot
hold two NCCL ranks of one communicator, so a test of the model axis on
one card puts that axis on gloo (over CUDA tensors) and keeps each rank's
federation axis a one-rank NCCL group (``set_axis_backends({"model":
"gloo", "data": "nccl"})``, which ``launch.cluster --axis-backends
model=gloo,data=nccl`` calls); an axis named there by none takes the
default group's backend.
Nothing here initialises the world: each builder raises without a
process group, or when the grid's size is not the world's.

Defined as functions (no grid is made at import), as the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

# H100 SXM peaks (NVIDIA's data sheet): device memory, f32 outside the
# tensor cores, dense bf16 on the tensor cores; its L2 cache; and NVLink 4
# (900 GB/s per card, both directions together)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
NVLINK_BYTES_PER_S = 900e9

FEDERATION = ("pod", "data")

_AXIS_BACKENDS: Dict[str, str] = {}


def parse_axis_backends(text: Optional[str]) -> Dict[str, str]:
    """'model=gloo,data=nccl' -> {"model": "gloo", "data": "nccl"}."""
    if not text:
        return {}
    out = {}
    for pair in text.split(","):
        axis, sep, backend = pair.partition("=")
        if not sep or not axis or not backend:
            raise ValueError(f"axis backends are axis=backend pairs, got "
                             f"{pair!r}")
        out[axis] = backend
    return out


def set_axis_backends(backends: Optional[Dict[str, str]]) -> None:
    """The per-axis backends of every later grid."""
    _AXIS_BACKENDS.clear()
    _AXIS_BACKENDS.update(backends or {})


Axes = Union[str, Tuple[str, ...]]


@dataclass(frozen=True, eq=False)
class Grid:
    """The named axes of a world of ranks and this rank's place on them.

    ``shape`` maps each axis to its size, in order (the reference's
    ``mesh.shape``); ``coords`` this rank's coordinate on each; ``group``
    the ``torch.distributed`` group of an axis or of a tuple of axes."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], object] = field(repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def axis_size(self, axes: Axes) -> int:
        """The product of the sizes of ``axes`` (1 for an axis the grid
        lacks)."""
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in _axes(axes))

    def coord(self, axes: Axes) -> int:
        """This rank's coordinate on ``axes``, row-major over them (0 for
        an axis the grid lacks)."""
        c = 0
        for a in _axes(axes):
            if a in self.axis_names:
                i = self.axis_names.index(a)
                c = c * self.sizes[i] + self.coords[i]
        return c

    def group(self, axes: Axes):
        """The group of this rank's ranks along ``axes`` (each axis must
        be the grid's)."""
        key = tuple(a for a in self.axis_names if a in _axes(axes))
        missing = [a for a in _axes(axes) if a not in self.axis_names]
        if missing:
            raise ValueError(f"grid has no {missing[0]!r} axis (axes: "
                             f"{self.axis_names})")
        return self.groups[key]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_sets(names: Sequence[str]):
    """Every single axis, and the composite federation axis where the grid
    has both of its axes."""
    sets = [(a,) for a in names]
    if all(a in names for a in FEDERATION):
        sets.append(FEDERATION)
    return sets


def make_grid(shape: Sequence[int], axis_names: Sequence[str]) -> Grid:
    """A grid of ``shape`` over the ranks of the initialised world.

    Each axis's groups take the backend ``set_axis_backends`` gave it (the
    composite federation axis takes ``data``'s); an axis named there by
    none takes the default group's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a process grid needs an initialised "
                           "torch.distributed process group: call "
                           "repro_torch.launch.cluster.init_distributed(...) "
                           "or dist.init_process_group(...) first")
    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"grid shape {shape} and axes {names} do not match")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"grid {dict(zip(names, shape))} has "
                         f"{math.prod(shape)} ranks, the world {world}")
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    ranks = np.arange(world).reshape(shape)
    groups = {}
    for axes in _axis_sets(names):
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        lists = ranks.transpose(rest + dims).reshape(
            -1, math.prod(shape[i] for i in dims)).tolist()
        backend = _AXIS_BACKENDS.get(axes[-1] if axes == FEDERATION else axes[0])
        groups[axes], _ = dist.new_subgroups_by_enumeration(
            lists, backend=backend)
    return Grid(names, shape, coords, groups)


def make_production_mesh(*, multi_pod: bool = False) -> Grid:
    """The reference's production layout: (data 16, model 16), or (pod 2,
    data 16, model 16) with ``multi_pod``; 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_grid(shape, axes)


def make_smoke_mesh(data: int = 1, model: int = 1) -> Grid:
    """A small (data, model) grid (tests, examples, one card)."""
    return make_grid((data, model), ("data", "model"))


def make_data_mesh(n_devices: Optional[int] = None) -> Grid:
    """The 1-D federation axis over every rank of the world (or
    ``n_devices`` of them, which must be the world's size)."""
    if n_devices is None and dist.is_available() and dist.is_initialized():
        n_devices = dist.get_world_size()
    return make_grid((n_devices or 0,), ("data",))
