"""LM parameter initialisation, counterpart of ``repro/models/params.py``
for the dense and SSM families.

Per-layer parameters are stacked with a leading (n_layers,) dim, as the
reference stacks them for ``lax.scan``; head-structured projections are
stored flattened, ``(d, H*hd)``, for ``x @ W``.  The reference's
``jax.random`` normals are not reproduced (``core.prng`` makes jax's
uniform bits, not XLA's f32 inverse-erf), so the port draws its own with
the reference's scales (normal * 0.02; zeros for norms and biases), on the
target device from a seeded ``torch.Generator``, straight into
``cfg.dtype``: a 15 B-parameter model is never materialised on the host.
Tests carry the reference's values across with
``repro_torch.params.lm_from_jax`` instead.  The SSM's ``A_log`` and
``dt_bias`` are the exception: the reference draws them from numpy's
``default_rng(0)``, and the port makes the same f32 values on the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def block_kinds(cfg: ArchConfig):
    """Returns [(params_key, kind, n_layers), ...] stack layout: one stack
    of SSM or dense blocks (the other families' layouts come with their
    slices)."""
    if cfg.family == "ssm":
        return [("blocks", "ssm", cfg.n_layers)]
    return [("blocks", "dense", cfg.n_layers)]


def check_ported(cfg: ArchConfig) -> None:
    """Raises for what the port does not run yet: any family but the dense
    one with GQA attention and the SSM one."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            f"port runs the dense GQA and the SSM families, the others come "
            f"with later slices")


def _ssm_init(H: int):
    """The reference's ``A_log`` and ``dt_bias`` init, (H,) f32 on the CPU:
    A = U(1, 16) and dt = exp(U(log 1e-3, log 1e-1)) clipped at 1e-4 from
    numpy's ``default_rng(0)``, stored as log(A) and softplus^-1(dt) =
    log(expm1(dt)), each op in f32 as the reference takes it."""
    rng = np.random.default_rng(0)
    a_init = torch.log(torch.tensor(rng.uniform(1.0, 16.0, size=(H,)),
                                    dtype=torch.float32))
    dt = np.clip(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(H,))),
                 1e-4, None)
    dt_init = torch.log(torch.expm1(torch.tensor(dt, dtype=torch.float32)))
    return a_init, dt_init


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> Dict[str, object]:
    """Fresh parameters in the reference's layout on ``device`` (the CUDA
    device unless the CPU is asked for)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape, scale=0.02):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=dtype).mul_(scale)

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
    for name, kind, L in block_kinds(cfg):
        if kind == "ssm":
            params[name] = {"ln1": norm(L),
                            "ssm": _ssm_params(cfg, L, dense, zeros, device)}
            continue
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


def _ssm_params(cfg: ArchConfig, L: int, dense, zeros, device):
    """The reference's ``_ssm_params`` leaves, stacked over L layers:
    projections and conv in ``cfg.dtype``, ``A_log``, ``D``, ``dt_bias``
    and ``ssm_norm`` in f32."""
    d, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_n_heads
    G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
    conv_ch = d_in + 2 * G * N
    a_init, dt_init = _ssm_init(H)
    return {
        "in_z": dense(L, d, d_in),
        "in_x": dense(L, d, d_in),
        "in_B": dense(L, d, G * N),
        "in_C": dense(L, d, G * N),
        "in_dt": dense(L, d, H),
        "conv_w": dense(L, K, conv_ch, scale=0.1),
        "conv_b": zeros(L, conv_ch),
        "A_log": a_init.repeat(L, 1).to(device),
        "D": torch.ones(L, H, device=device),
        "dt_bias": dt_init.repeat(L, 1).to(device),
        "ssm_norm": zeros(L, d_in, dt=torch.float32),
        "out_proj": dense(L, d_in, d),
    }


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
