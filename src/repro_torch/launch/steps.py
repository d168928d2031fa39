"""Step builders for the LM architectures: the federated train round,
prefill and decode; counterpart of ``repro/launch/steps.py`` without a
mesh.

For each (arch x input shape) this module gives:
  * the step function (a federated train round through ``fed.LMTask``'s
    loss, a prefill, a decode step),
  * its inputs as tensors on the ``meta`` device: the reference's shapes
    and dtypes, nothing allocated (``abstract_params``: deepseek-v3-671b's
    1.34 TB tree costs nothing).

The reference also places each input on a device mesh (in and out
shardings, FSDP x TP param specs); the port shards no params yet (ROADMAP
item 6), so a ``StepBundle`` carries no shardings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.fed_step import flatten_tree, make_fed_round
from repro_torch.fed.task import LMTask
from repro_torch.models import transformer
from repro_torch.models.params import init_params, torch_dtype

META = torch.device("meta")


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
    """A step function, its inputs after the params as meta tensors (the
    params first in ``input_specs``), and what it was built for.  No
    shardings: the port places no params on a mesh yet (ROADMAP item
    6)."""
    fn: Callable
    input_specs: Tuple
    meta: Dict = None


# ---------------------------------------------------------------------------
# Train (federated round) step
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, shape: InputShape,
                    ranks: int = 1) -> StepBundle:
    """The federated round at ``shape``: C clients of E local steps on
    batches of b = max(1, global_batch // C) sequences.  C is ``ranks`` in
    client-parallel mode (the reference fills the client axis across its
    mesh's pod x data devices) and ``fed.clients_per_round`` in
    client-sequential mode.  ``fn(params, batches, alpha, coeffs, eta)``
    takes the nested param tree and returns (params, metrics), the round
    written into the tree's tensors."""
    fed = cfg.fed
    C = ranks if fed.mode == "client_parallel" else fed.clients_per_round
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
    task = LMTask(cfg, seq_len=S_text, fsdp=fed.mode != "client_parallel")
    round_fn = make_fed_round(task.loss_fn, fed.mode)

    def step(params, batches, alpha, coeffs, eta):
        _, metrics = round_fn(flatten_tree(params), batches, alpha, coeffs,
                              eta)
        return params, metrics

    input_specs = (abstract_params(cfg), batch_specs,
                   _spec((C, E), torch.float32), _spec((C,), torch.float32),
                   _spec((), torch.float32))
    return StepBundle(step, input_specs,
                      meta={"clients": C, "local_epochs": E,
                            "client_batch": b, "mode": fed.mode})


# ---------------------------------------------------------------------------
# Serve steps (prefill / decode)
# ---------------------------------------------------------------------------


def make_decode_step(cfg: ArchConfig, shape: InputShape) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len

    def step(params, cache, token, pos):
        return transformer.decode_step(params, cfg, cache, token, pos)

    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks else (B, 1)
    input_specs = (abstract_params(cfg),
                   transformer.init_cache(cfg, B, S, device=META),
                   _spec(tok_shape, torch.int32), _spec((), torch.int32))
    return StepBundle(step, input_specs, meta={"batch": B, "cache_len": S})


def make_prefill_step(cfg: ArchConfig, shape: InputShape) -> StepBundle:
    B, S = shape.global_batch, shape.seq_len
    S_text = S - cfg.n_patches if cfg.n_patches else S

    def step(params, tokens, patch_emb=None):
        cache = transformer.init_cache(cfg, B, S, device=tokens.device)
        return transformer.prefill(params, cfg, tokens, cache,
                                   patch_emb=patch_emb)

    tok_shape = (B, S_text, cfg.n_codebooks) if cfg.n_codebooks \
        else (B, S_text)
    input_specs = [abstract_params(cfg), _spec(tok_shape, torch.int32)]
    if cfg.n_patches:
        input_specs.append(_spec((B, cfg.n_patches, cfg.d_model),
                                 torch_dtype(cfg)))
    return StepBundle(step, tuple(input_specs), meta={"batch": B, "seq": S})


def make_step(cfg: ArchConfig, shape: InputShape,
              ranks: int = 1) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, shape, ranks)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape)
    return make_decode_step(cfg, shape)
