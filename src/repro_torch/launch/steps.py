"""Step builders for the LM architectures: the federated train round,
prefill and decode; counterpart of ``repro/launch/steps.py``.

For each (arch x input shape) this module gives:
  * the step function (a federated train round through ``fed.LMTask``'s
    loss, a prefill, a decode step),
  * its inputs as tensors on the ``meta`` device: the reference's shapes
    and dtypes, nothing allocated (``abstract_params``: deepseek-v3-671b's
    1.34 TB tree costs nothing),
  * given a grid (``mesh=``, ``launch.mesh``), each input's placement as
    a spec tree (``in_shardings``, ``out_shardings``): the params by the
    rule table (``models.sharding``), the batch over ``_batch_axes``, the
    cache by ``_cache_sharding_tree``.

Over a grid the step runs under it (``models.sharding.use_mesh``): it
takes the rank's param shards (``models.params.shard_params``) and the
whole inputs, and cuts the rank's share of them by their placement, the
clients of a train round over the federation axes (the round then sums
the rank's shard of the deltas over them), the requests of a serving
batch over ``_batch_axes``; a serving step returns the rank's requests'
logits and cache.  Serving reaches the grid only through these builders
(and ``transformer.prefill``/``decode_step`` under ``use_mesh``): the
reference's ``serve`` takes no mesh either.  FSDP over the data axis
(``serve_fsdp``'s placement, the client-sequential round's) is given as
a placement and not executed: the port raises where it would be.
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.fed_step import (fed_round_parallel, flatten_tree,
                                       make_fed_round)
from repro_torch.fed.sharding import FedSharding
from repro_torch.fed.task import LMTask
from repro_torch.models import transformer
from repro_torch.models.params import init_params, torch_dtype
from repro_torch.models.sharding import (_filter_spec, tree_param_specs,
                                         use_mesh)

META = torch.device("meta")
BATCH = ("pod", "data")


def _batch_axes(B: int, mesh):
    """Largest prefix of (pod, data) whose product divides B (long_500k has
    B=1 and must replicate)."""
    axes = [a for a in BATCH if a in mesh.shape]
    while axes:
        if B % math.prod(mesh.shape[a] for a in axes) == 0:
            return tuple(axes)
        axes.pop(0)
    return None


def _specs_on(mesh, tree):
    """A spec tree filtered to the grid's axes."""
    if isinstance(tree, dict):
        return {k: _specs_on(mesh, v) for k, v in tree.items()}
    return _filter_spec(tree, mesh)


def _rows(x, mesh, axes):
    """The rank's block of dim 0 of ``x`` over ``axes`` of ``mesh``."""
    if x is None or not axes:
        return x
    n = mesh.axis_size(axes)
    b = x.shape[0] // n
    c = mesh.coord(axes)
    return x[c * b:(c + 1) * b]


def _grid(mesh):
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Parameter shapes without allocation
# ---------------------------------------------------------------------------


def abstract_params(cfg: ArchConfig):
    """The parameter tree of ``cfg`` on the meta device: the reference's
    keys, shapes and dtypes."""
    return init_params(cfg, device=META)


def param_bytes(cfg: ArchConfig) -> int:
    return sum(p.numel() * p.element_size()
               for p in flatten_tree(abstract_params(cfg)).values())


def serve_fsdp(cfg: ArchConfig) -> bool:
    """The reference's rule: shard serve-time params over the data axis
    too when a model-only (16-way) shard would not leave room for the KV
    cache."""
    return param_bytes(cfg) / 16 > 6e9


@dataclass
class StepBundle:
    """A step function, its inputs as meta tensors (the params first in
    ``input_specs``), each input's placement on the grid it was built for
    (``in_shardings``: spec trees, params first; ``out_shardings``; both
    None without a grid), and what it was built for."""
    fn: Callable
    input_specs: Tuple
    meta: Dict = None
    in_shardings: Optional[Tuple] = None
    out_shardings: Any = None


# ---------------------------------------------------------------------------
# Train (federated round) step
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, shape: InputShape,
                    ranks: int = 1, mesh=None) -> StepBundle:
    """The federated round at ``shape``: C clients of E local steps on
    batches of b = max(1, global_batch // C) sequences.  C is, in
    client-parallel mode, the grid's pod x data ranks (``mesh``; the
    reference fills the client axis across them) or ``ranks`` without a
    grid, and ``fed.clients_per_round`` in client-sequential mode.
    ``fn(params, batches, alpha, coeffs, eta)`` takes the nested param
    tree (over a grid, the rank's shards) and the whole round's inputs,
    and returns (params, metrics), the round written into the tree's
    tensors: over a grid each rank trains its clients (TP/EP over
    ``model``) and the deltas are summed over the federation axes."""
    fed = cfg.fed
    parallel = fed.mode == "client_parallel"
    if mesh is not None and parallel:
        ranks = math.prod(mesh.shape[a] for a in BATCH if a in mesh.shape)
    C = ranks if parallel else fed.clients_per_round
    E = fed.local_epochs
    b = max(1, shape.global_batch // C)
    S_text = shape.seq_len - cfg.n_patches if cfg.n_patches else \
        shape.seq_len
    tok_shape = (C, E, b, S_text)
    if cfg.n_codebooks:
        tok_shape = tok_shape + (cfg.n_codebooks,)
    batch_specs = {"tokens": _spec(tok_shape, torch.int32),
                   "labels": _spec(tok_shape, torch.int32)}
    if cfg.n_patches:
        batch_specs["patch_emb"] = _spec((C, E, b, cfg.n_patches,
                                          cfg.d_model), torch_dtype(cfg))

    # the same ClientTask the federation engine uses (fed/task.py): the
    # train step and a live federated round share one loss path
    task = LMTask(cfg, seq_len=S_text, fsdp=not parallel)
    aparams = abstract_params(cfg)
    if mesh is None:
        round_fn = make_fed_round(task.loss_fn, fed.mode)
        in_sh = out_sh = None
    else:
        if not parallel:
            raise NotImplementedError(
                "the client-sequential round over a grid (FSDP over the "
                "data axis) is ROADMAP item 6's next step")
        axes = tuple(a for a in BATCH if a in mesh.shape) or ("data",)
        fs = FedSharding(mesh=mesh,
                         axis=axes[0] if len(axes) == 1 else axes)
        round_fn = functools.partial(fed_round_parallel, task.loss_fn,
                                     sharding=fs)
        client = fs.client_spec(1)[0]
        # the rule table with the federation axes stripped (pure TP), as
        # the engine keeps it in client-parallel mode
        pspecs = _specs_on(mesh, tree_param_specs(aparams, fsdp=False))
        tok = (client,) + (None,) * (len(tok_shape) - 1)
        bsh = {k: tok for k in ("tokens", "labels")}
        if cfg.n_patches:
            bsh["patch_emb"] = (client, None, None, None, None)
        in_sh = (pspecs, bsh, (client, None), (client,), ())
        out_sh = (pspecs, None)

    def step(params, batches, alpha, coeffs, eta):
        if mesh is not None:
            batches = {k: fs.shard(v) for k, v in batches.items()}
            alpha, coeffs = fs.shard(alpha), fs.shard(coeffs)
        with _grid(mesh):
            _, metrics = round_fn(flatten_tree(params), batches, alpha,
                                  coeffs, eta)
        return params, metrics

    input_specs = (aparams, batch_specs,
                   _spec((C, E), torch.float32), _spec((C,), torch.float32),
                   _spec((), torch.float32))
    return StepBundle(step, input_specs,
                      meta={"clients": C, "local_epochs": E,
                            "client_batch": b, "mode": fed.mode},
                      in_shardings=in_sh, out_shardings=out_sh)


# ---------------------------------------------------------------------------
# Serve steps (prefill / decode)
# ---------------------------------------------------------------------------


def _cache_sharding_tree(cfg, cache_struct, mesh, baxes):
    """Cache leaves, (L, B, slots, ...): batch over ``baxes`` and the
    rank's heads over 'model', in the port's layout: the GQA kv dim (a
    copied KV head where the axis is wider than the KV heads), the SSM
    conv's channels (its x block then every B and C channel) and the SSM
    state's heads (the reference splits its head dim); the MLA latents are
    replicated (the reference splits their slots)."""

    def spec_for(name, leaf):
        if name in ("k", "v"):      # (L, B, slots, KV*hd) flattened kv dim
            return (None, baxes, None, "model")
        if name in ("ckv", "krope", "pos_map"):
            return (None,) * leaf.ndim if name == "pos_map" else \
                (None, baxes, None, None)
        if name == "conv":
            return (None, baxes, None, "model")
        if name == "state":         # (L, B, G, hg, P, N): heads over model
            return (None, baxes, None, "model", None, None)
        return (None,) * leaf.ndim

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return _filter_spec(spec_for(name, tree), mesh)

    return walk(cache_struct)


def make_decode_step(cfg: ArchConfig, shape: InputShape,
                     mesh=None) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    baxes = _batch_axes(B, mesh) if mesh is not None else None

    def step(params, cache, token, pos):
        with _grid(mesh):
            return transformer.decode_step(params, cfg, cache,
                                           _rows(token, mesh, baxes), pos)

    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    cache_struct = transformer.init_cache(cfg, B, S, device=META)
    input_specs = (abstract_params(cfg), cache_struct,
                   _spec(tok_shape, torch.int32), _spec((), torch.int32))
    in_sh = out_sh = None
    if mesh is not None:
        cache_sh = _cache_sharding_tree(cfg, cache_struct, mesh, baxes)
        in_sh = (_specs_on(mesh, tree_param_specs(
            input_specs[0], fsdp=serve_fsdp(cfg))), cache_sh,
            _filter_spec((baxes,) + (None,) * (len(tok_shape) - 1), mesh),
            ())
        out_sh = (None, cache_sh)
    return StepBundle(step, input_specs, meta={"batch": B, "cache_len": S},
                      in_shardings=in_sh, out_shardings=out_sh)


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      mesh=None) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    S_text = S - cfg.n_patches if cfg.n_patches else S
    baxes = _batch_axes(B, mesh) if mesh is not None else None

    def step(params, tokens, patch_emb=None):
        tokens = _rows(tokens, mesh, baxes)
        patch_emb = _rows(patch_emb, mesh, baxes)
        with _grid(mesh):
            cache = transformer.init_cache(cfg, tokens.shape[0], S,
                                           device=tokens.device)
            return transformer.prefill(params, cfg, tokens, cache,
                                       patch_emb=patch_emb)

    tok_shape = (B, S_text, cfg.n_codebooks) if cfg.n_codebooks \
        else (B, S_text)
    input_specs = [abstract_params(cfg), _spec(tok_shape, torch.int32)]
    in_sh = None
    if mesh is not None:
        in_sh = [_specs_on(mesh, tree_param_specs(
            input_specs[0], fsdp=serve_fsdp(cfg))),
            _filter_spec((baxes, None) + (None,) * (len(tok_shape) - 2),
                         mesh)]
    if cfg.n_patches:
        input_specs.append(_spec((B, cfg.n_patches, cfg.d_model),
                                 torch_dtype(cfg)))
        if in_sh is not None:
            in_sh.append(_filter_spec((baxes, None, None), mesh))
    return StepBundle(step, tuple(input_specs), meta={"batch": B, "seq": S},
                      in_shardings=None if in_sh is None else tuple(in_sh))


def make_step(cfg: ArchConfig, shape: InputShape, ranks: int = 1,
              mesh=None) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, shape, ranks, mesh)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh)
    return make_decode_step(cfg, shape, mesh)
