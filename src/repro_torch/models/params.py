"""LM parameter initialisation, counterpart of ``repro/models/params.py``
for the dense family.

Per-layer parameters are stacked with a leading (n_layers,) dim, as the
reference stacks them for ``lax.scan``; head-structured projections are
stored flattened, ``(d, H*hd)``, for ``x @ W``.  The reference's
``jax.random`` values cannot be reproduced, so the port draws its own with
the reference's scales (normal * 0.02; zeros for norms and biases), on the
target device from a seeded ``torch.Generator``, straight into
``cfg.dtype``: a 15 B-parameter model is never materialised on the host.
Tests carry the reference's values across with
``repro_torch.params.lm_from_jax`` instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def block_kinds(cfg: ArchConfig):
    """Returns [(params_key, kind, n_layers), ...] stack layout: one stack
    of dense blocks (the other families' layouts come with their slices)."""
    return [("blocks", "dense", cfg.n_layers)]


def check_ported(cfg: ArchConfig) -> None:
    """Raises for what the port does not run yet: any family but the dense
    one with GQA attention."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            f"port runs the dense GQA family, the others come with later "
            f"slices")


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> Dict[str, object]:
    """Fresh parameters in the reference's layout on ``device`` (the CUDA
    device unless the CPU is asked for)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=dtype).mul_(0.02)

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, device=device, dtype=dt)

    def norm(*s):   # norms are f32 in the reference
        p = {"scale": zeros(*s, cfg.d_model, dt=torch.float32)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(*s, cfg.d_model, dt=torch.float32)
        return p

    d, hd, V = cfg.d_model, cfg.head_dim, cfg.vocab_padded
    H, KV = cfg.n_heads, cfg.n_kv_heads
    params = {"embed": dense(V, d)}
    for name, _kind, L in block_kinds(cfg):
        attn = {"wq": dense(L, d, H * hd), "wk": dense(L, d, KV * hd),
                "wv": dense(L, d, KV * hd), "wo": dense(L, H * hd, d)}
        mlp = {}
        if cfg.gated_mlp:
            mlp["w_gate"] = dense(L, d, cfg.d_ff)
        mlp["w_up"] = dense(L, d, cfg.d_ff)
        mlp["w_down"] = dense(L, cfg.d_ff, d)
        if cfg.use_bias:
            attn.update(bq=zeros(L, H * hd), bk=zeros(L, KV * hd),
                        bv=zeros(L, KV * hd), bo=zeros(L, d))
            mlp.update(b_up=zeros(L, cfg.d_ff), b_down=zeros(L, d))
        block = {"ln1": norm(L), "attn": attn, "mlp": mlp}
        if not cfg.parallel_residual:
            block["ln2"] = norm(L)
        params[name] = block
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, V)
    return params


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
