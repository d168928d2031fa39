"""The grid context, the partition rule table and the model axis's
collectives; counterpart of ``repro/models/sharding.py``.

The model code is grid-agnostic: without a grid installed by
``use_mesh`` (or with a model axis of one rank) every function of the
model computes what it did before this module existed, bit for bit.
Under a grid whose ``model`` axis has m > 1 ranks each rank holds its own
shards of the params (``models.params.shard_params``) and the model code
runs tensor parallelism (TP) and expert parallelism (EP) explicitly,
where the reference leaves the collectives to GSPMD:

  * column-parallel projections (wq/wk/wv, w_gate/w_up, in_z/in_x, the
    MLA up-projections, the vocab of the head) read a replicated input
    through ``copy_to_model``: the identity forward, an all-reduce of the
    gradient backward, since each rank's gradient is only its shards'
    share;
  * row-parallel projections (wo, w_down, out_proj) and the embedding's
    masked lookup end in ``reduce_from_model``: an all-reduce forward,
    the identity backward, the replicated output's gradient being whole
    on every rank already;
  * the vocab-parallel logits are gathered (``gather_from_model``) and
    copied KV heads sum their gradients over the ranks holding them
    (``sum_copies``).

``torch.distributed.nn.functional.all_reduce`` is not used: its backward
all-reduces again, which counts a replicated gradient m times.  Every
model-axis collective is an ``all_reduce`` (a gather is an all-reduce
into a zeroed buffer), so one code path runs under NCCL, gloo on the CPU
and gloo with CUDA tensors, which takes only all-reduce and broadcast.

The rule table (``param_spec``) is the reference's, key for key; specs
are plain tuples of entries (an axis name, a tuple of names, or None).
The port's layout follows it wherever the axis divides the sharded dim,
except in three places, stated where they are cut
(``models.params.shard_params``) and tested as stated:

  1. KV heads: where ``model`` has more ranks than the model has KV heads
     (m % KV == 0), each rank holds a copy of the one KV head its query
     heads read, (d, hd), not a 1/m slice of a head, which attention
     cannot use;
  2. the MLA latent cache (``ckv``, ``krope``) is replicated, where the
     reference shards its slots: every head reads every slot;
  3. the SSM's conv channels (``conv_w``, ``conv_b`` and the conv cache):
     the x channels are split with the heads and the B and C channels are
     whole on every rank (in_B and in_C are replicated); and its state
     cache is split by heads, where the reference splits the head dim.

``constrain`` is the identity with or without a grid: a tensor of the
port is already the rank's own.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# The ambient grid: one per process (each rank is its own process), so
# autograd's device thread, which runs backward passes and checkpoint
# recomputation, sees the grid the calling thread installed.
_state = {"mesh": None}

# Batch-like dims (clients, batch) shard over pod+data.
BATCH = ("pod", "data")

# model-axis collectives since the last reset (``collective_stats``); with
# ``time_collectives(True)`` also their seconds, each synchronised
STATS = {"all_reduce": 0, "bytes": 0, "seconds": 0.0}
_timing = {"on": False}


def current_mesh():
    return _state["mesh"]


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` (a ``launch.mesh.Grid``) as the ambient grid of the
    model code; None installs none."""
    prev = current_mesh()
    _state["mesh"] = mesh
    try:
        yield mesh
    finally:
        _state["mesh"] = prev


def constrain(x, spec):
    """The identity: the port's tensors are the rank's own already (the
    reference's ``with_sharding_constraint`` steers GSPMD)."""
    return x


def _filter_spec(spec, mesh) -> Tuple:
    """Drop axis names the grid lacks (e.g. 'pod' on one pod); singleton
    tuples become the bare name, as the reference normalises them."""
    names = set(mesh.axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            if not kept:
                return None
            return kept[0] if len(kept) == 1 else kept
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ---------------------------------------------------------------------------
# Parameter partition rules, keyed by leaf path fragments (the reference's)
# ---------------------------------------------------------------------------


def param_spec(path: str, ndim: int, *, fsdp: bool, stacked: bool) -> Tuple:
    """The spec of a parameter leaf.

    path     -- '/'-joined path, e.g. 'blocks/attn/wq'.
    stacked  -- leaf has a leading (n_layers,) dim.
    fsdp     -- also shard the non-TP big dim over ('pod', 'data').
    """
    name = path.split("/")[-1]
    d_ax = ("pod", "data") if fsdp else None
    body = ndim - (1 if stacked else 0)

    def spec(*entries):
        entries = list(entries) + [None] * (body - len(entries))
        if stacked:
            entries = [None] + entries
        return tuple(entries)

    # --- attention (flattened (d, H*hd) projections) ---
    if name in ("wq", "wk", "wv"):
        return spec(d_ax, "model")
    if name == "wo":
        return spec("model", d_ax)
    if name in ("bq", "bk", "bv"):
        return spec("model")
    if name == "bo":
        return spec(None)
    # --- MLA (flattened (rank, H*dim) up-projections) ---
    if name in ("w_dq", "w_dkv"):
        return spec(d_ax, None)
    if name in ("w_uq", "w_uk", "w_uv"):
        return spec(None, "model")
    # --- MLP ---
    if name in ("w_gate", "w_up"):
        if body == 3:  # experts (E, d, f)
            return spec("model", d_ax, None)
        return spec(d_ax, "model")
    if name == "w_down":
        if body == 3:  # experts (E, f, d)
            return spec("model", None, d_ax)
        return spec("model", d_ax)
    if name == "b_up":
        return spec("model")
    if name == "b_down":
        return spec(None)
    if name in ("router", "router_bias"):
        return spec(None)
    # --- SSM ---
    if name in ("in_z", "in_x"):
        return spec(d_ax, "model")
    if name in ("in_B", "in_C", "in_dt"):
        return spec(d_ax, None)
    if name in ("conv_w", "conv_b"):
        return spec(None, "model") if body == 2 else spec("model")
    if name in ("A_log", "D", "dt_bias"):
        return spec(None)
    if name == "ssm_norm":
        return spec("model")
    if name == "out_proj":
        return spec("model", d_ax)
    # --- embeddings / heads ---
    if name == "embed":
        # (V, d) or (K, V, d) for audio codebooks
        return (None, "model", None) if ndim == 3 else ("model", None)
    if name == "lm_head":
        # (d, V) or (K, d, V)
        return (None, None, "model") if ndim == 3 else (None, "model")
    if name in ("patch_proj", "mtp_proj"):
        return spec(d_ax, None)
    # --- norms, scalars, everything else: replicated ---
    return (None,) * ndim


def tree_param_specs(params, *, fsdp: bool):
    """A nested dict of specs matching ``params`` (a nested dict of
    tensors); a subtree whose key ends with 'blocks' holds stacked
    (n_layers, ...) leaves."""

    def walk(tree, prefix, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k,
                            stacked or k.endswith("blocks"))
                    for k, v in tree.items()}
        return param_spec(prefix, tree.ndim, fsdp=fsdp, stacked=stacked)

    return walk(params, "", False)


# ---------------------------------------------------------------------------
# The port's layout: which elements of a leaf a rank holds
# ---------------------------------------------------------------------------


def local_kv_heads(cfg, m: int) -> int:
    """KV heads a rank holds at m model ranks: KV / m, or one copy where
    m % KV == 0 (layout departure 1)."""
    KV = cfg.n_kv_heads
    if KV % m == 0:
        return KV // m
    if m % KV == 0:
        return 1
    raise ValueError(f"{cfg.name}: {KV} KV heads cannot be laid over a "
                     f"model axis of {m} ranks")


def check_heads(cfg, m: int) -> None:
    """Raise unless every head-structured dim of ``cfg`` splits over m
    model ranks by whole heads."""
    checks = []
    if cfg.n_heads:
        checks.append(("query heads", cfg.n_heads))
        if not cfg.use_mla:
            local_kv_heads(cfg, m)
    if cfg.family in ("ssm", "hybrid"):
        checks.append(("SSM heads", cfg.ssm_n_heads))
    if cfg.n_experts:
        checks.append(("experts", cfg.n_experts))
    for what, n in checks:
        if n % m:
            raise ValueError(f"{cfg.name}: {n} {what} do not split over a "
                             f"model axis of {m} ranks")


def _kv_leaf(name: str, cfg) -> bool:
    return (name in ("wk", "wv", "bk", "bv") and not cfg.use_mla
            and cfg.n_kv_heads > 0)


def leaf_index(path: str, shape, spec, cfg, sizes: dict, coords: dict):
    """Per dim of a leaf of ``shape``, what rank ``coords`` holds of it
    under ``spec`` on a grid of ``sizes``: a slice, or an index tensor
    (the conv channels), or None (the whole dim).  Blocks are the rank's
    contiguous ones, the reference's NamedSharding shard, but at the
    stated departures (KV copies, conv channels)."""
    name = path.split("/")[-1]
    out = []
    for dim, entry in zip(shape, spec):
        axes = [a for a in _entry_axes(entry) if a in sizes]
        n = math.prod(sizes[a] for a in axes)
        if n == 1:
            out.append(None)
            continue
        c = 0
        for a in axes:
            c = c * sizes[a] + coords[a]
        if axes == ["model"] and _kv_leaf(name, cfg) \
                and cfg.n_kv_heads % n and n % cfg.n_kv_heads == 0:
            # departure 1: the KV head this rank's query heads read
            hd = dim // cfg.n_kv_heads
            j = c // (n // cfg.n_kv_heads)
            out.append(slice(j * hd, (j + 1) * hd))
            continue
        if axes == ["model"] and name in ("conv_w", "conv_b"):
            # departure 3: the x channels by heads, B and C whole
            d_in = cfg.d_inner
            if d_in % n:
                raise ValueError(f"{path}: d_inner {d_in} does not split "
                                 f"over {n} model ranks")
            dl = d_in // n
            out.append(torch.cat([torch.arange(c * dl, (c + 1) * dl),
                                  torch.arange(d_in, dim)]))
            continue
        if dim % n:
            raise ValueError(f"{path}: dim {dim} of {tuple(shape)} does not "
                             f"split over {n} ranks of {entry}")
        out.append(slice(c * (dim // n), (c + 1) * (dim // n)))
    return out


def take(leaf: torch.Tensor, index) -> torch.Tensor:
    """The rank's elements of ``leaf`` (``leaf_index``'s), as a tensor of
    its own."""
    out = leaf
    for d, ix in enumerate(index):
        if ix is None:
            continue
        if isinstance(ix, slice):
            out = out.narrow(d, ix.start, ix.stop - ix.start)
        else:
            out = out.index_select(d, ix.to(leaf.device))
    return out.clone(memory_format=torch.contiguous_format)


def local_shape(path: str, shape, spec, cfg, sizes: dict) -> Tuple[int, ...]:
    """The shape of a rank's shard (every rank's is the same)."""
    index = leaf_index(path, shape, spec, cfg, sizes,
                       {a: 0 for a in sizes})
    return tuple(d if ix is None else
                 (ix.stop - ix.start if isinstance(ix, slice) else len(ix))
                 for d, ix in zip(shape, index))


def copies_weight(path: str, shape, spec, cfg, m: int):
    """1 / (model ranks holding each element of the rank's shard): a
    number, or a vector over the conv channels (its last dim); for sums
    over the model axis that count each element once."""
    name = path.split("/")[-1]
    if "model" not in [a for e in spec for a in _entry_axes(e)]:
        return 1.0 / m
    if _kv_leaf(name, cfg) and cfg.n_kv_heads % m and \
            m % cfg.n_kv_heads == 0:
        return cfg.n_kv_heads / m
    if name in ("conv_w", "conv_b"):
        dl = cfg.d_inner // m
        w = torch.full((shape[-1],), 1.0 / m)
        w[:dl] = 1.0
        return w
    return 1.0


# ---------------------------------------------------------------------------
# The model axis and its collectives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: m ranks, this one ``rank``."""
    size: int
    rank: int
    group: object


def model_axis(mesh=None, *, single: bool = False) -> Optional[ModelAxis]:
    """The model axis of ``mesh`` (default: the ambient grid), or None
    without one or, unless ``single``, at one rank (the unsharded path)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or "model" not in mesh.axis_names:
        return None
    m = mesh.shape["model"]
    if m == 1 and not single:
        return None
    return ModelAxis(m, mesh.coord("model"), mesh.group("model"))


def collective_stats(reset: bool = False) -> dict:
    out = dict(STATS)
    if reset:
        STATS.update(all_reduce=0, bytes=0, seconds=0.0)
    return out


def time_collectives(on: bool) -> None:
    """Time every model-axis all-reduce (the device synchronised around
    it) into ``STATS["seconds"]``; off by default."""
    _timing["on"] = bool(on)


def _all_reduce(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Sum ``t`` (a tensor of its own) over the model axis, in place."""
    STATS["all_reduce"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    if _timing["on"]:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        STATS["seconds"] += time.perf_counter() - t0
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=axis.group)
    return t


def _own(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(_own(g), ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(_own(x), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        n = x.shape[dim]
        ctx.dim, ctx.n, ctx.rank = dim, n, axis.rank
        shape = list(x.shape)
        shape[dim] = n * axis.size
        full = x.new_zeros(shape)
        full.narrow(dim, axis.rank * n, n).copy_(x)
        return _all_reduce(full, axis)

    @staticmethod
    def backward(ctx, g):
        return _own(g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n)), None, None


class _SumCopies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, slot, n_slots, axis):
        ctx.args = (dim, slot, n_slots, axis)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        dim, slot, n_slots, axis = ctx.args
        n = g.shape[dim]
        shape = list(g.shape)
        shape[dim] = n * n_slots
        buf = g.new_zeros(shape)
        buf.narrow(dim, slot * n, n).copy_(g)
        _all_reduce(buf, axis)
        return _own(buf.narrow(dim, slot * n, n)), None, None, None, None


def copy_to_model(x, axis: Optional[ModelAxis]):
    """Identity forward; backward, the gradient summed over the model
    axis.  For a replicated tensor that enters rank-partial work."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x, axis: Optional[ModelAxis]):
    """Forward, the partial sums added over the model axis; backward, the
    identity.  For a rank-partial result that leaves replicated."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x, dim: int, axis: Optional[ModelAxis]):
    """The ranks' blocks of ``dim`` in rank order (an all-reduce into a
    zeroed buffer); backward, the rank's block of the gradient."""
    return x if axis is None else _GatherFromModel.apply(x, dim, axis)


def sum_copies(w, dim: int, slot: int, n_slots: int,
               axis: Optional[ModelAxis]):
    """Identity forward on a copied block (``slot`` of ``n_slots`` along
    ``dim``: a copied KV head); backward, its gradient summed over every
    rank holding the same block."""
    return w if axis is None else _SumCopies.apply(w, dim, slot, n_slots,
                                                   axis)
