"""LM parameter initialisation, counterpart of ``repro/models/params.py``
for every family: dense (GQA or MLA attention), MoE, SSM, hybrid, the
multimodal backbone (dense blocks; its patch embeddings come with the
batch) and audio (K codebooks: a (K, Vp, d) embedding and a (K, d, Vp)
head), the multi-token-prediction subtree included: the tree is the
reference's key for key, shape for shape and dtype for dtype.

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
    """Returns [(params_key, kind, n_layers), ...] stack layout."""
    if cfg.family == "ssm":
        return [("blocks", "ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [("blocks", "hybrid", cfg.n_layers)]
    if cfg.family == "moe":
        out = []
        if cfg.first_k_dense:
            out.append(("dense_blocks", "dense", cfg.first_k_dense))
        out.append(("moe_blocks", "moe", cfg.n_layers - cfg.first_k_dense))
        return out
    return [("blocks", "dense", cfg.n_layers)]


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
    device unless the CPU is asked for; on ``"meta"`` the tree's shapes and
    dtypes, nothing allocated or drawn)."""
    device = resolve_device(device, meta=True)
    dtype = torch_dtype(cfg)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def dense(*shape, scale=0.02, dt=dtype):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=dt).mul_(scale)

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, device=device, dtype=dt)

    def norm(*s):   # norms are f32 in the reference
        p = {"scale": zeros(*s, cfg.d_model, dt=torch.float32)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(*s, cfg.d_model, dt=torch.float32)
        return p

    draw = (dense, zeros, norm, device)
    K = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    params = {"embed": dense(*K, cfg.vocab_padded, cfg.d_model)}
    for name, kind, L in block_kinds(cfg):
        params[name] = _block_params(cfg, kind, (L,), draw)
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(*K, cfg.d_model, cfg.vocab_padded)
    if cfg.mtp_depth:
        params["mtp"] = {
            "mtp_proj": dense(2 * cfg.d_model, cfg.d_model),
            "block": _block_params(cfg, "dense", (), draw),
            "norm": norm(),
        }
    return params


def _block_params(cfg: ArchConfig, kind: str, s: tuple, draw):
    """One block's (or, with s = (L,), a stack's) leaves, as the
    reference's ``_block_params`` lays them out."""
    dense, zeros, norm, device = draw
    p = {"ln1": norm(*s)}
    if kind == "ssm":
        p["ssm"] = _ssm_params(cfg, s, dense, zeros, device)
    elif kind == "hybrid":
        p["attn"] = _attn_params(cfg, s, dense, zeros)
        p["ssm"] = _ssm_params(cfg, s, dense, zeros, device)
        p["ln_a"] = norm(*s)
        p["ln_s"] = norm(*s)
        p["ln2"] = norm(*s)
        p["mlp"] = _mlp_params(cfg, s, cfg.d_ff, dense, zeros)
    elif kind == "moe":
        p["attn"] = _attn_params(cfg, s, dense, zeros)
        p["ln2"] = norm(*s)
        p["moe"] = _moe_params(cfg, s, dense, zeros)
    else:  # dense
        p["attn"] = _attn_params(cfg, s, dense, zeros)
        p["mlp"] = _mlp_params(cfg, s, cfg.d_ff, dense, zeros)
        if not cfg.parallel_residual:
            p["ln2"] = norm(*s)
    return p


def _attn_params(cfg: ArchConfig, s: tuple, dense, zeros):
    """GQA or MLA attention, head projections flattened ((d, H*hd) etc.)."""
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        r = cfg.kv_lora_rank
        p = {}
        if cfg.q_lora_rank:
            p["w_dq"] = dense(*s, d, cfg.q_lora_rank)
            p["q_ln"] = {"scale": zeros(*s, cfg.q_lora_rank,
                                        dt=torch.float32)}
            p["w_uq"] = dense(*s, cfg.q_lora_rank, H * qk)
        else:
            p["wq"] = dense(*s, d, H * qk)
        p["w_dkv"] = dense(*s, d, r + cfg.qk_rope_dim)
        p["kv_ln"] = {"scale": zeros(*s, r, dt=torch.float32)}
        p["w_uk"] = dense(*s, r, H * cfg.qk_nope_dim)
        p["w_uv"] = dense(*s, r, H * cfg.v_head_dim)
        p["wo"] = dense(*s, H * cfg.v_head_dim, d)
        return p
    p = {"wq": dense(*s, d, H * hd), "wk": dense(*s, d, KV * hd),
         "wv": dense(*s, d, KV * hd), "wo": dense(*s, H * hd, d)}
    if cfg.use_bias:
        p.update(bq=zeros(*s, H * hd), bk=zeros(*s, KV * hd),
                 bv=zeros(*s, KV * hd), bo=zeros(*s, d))
    return p


def _mlp_params(cfg: ArchConfig, s: tuple, d_ff: int, dense, zeros):
    d = cfg.d_model
    p = {}
    if cfg.gated_mlp:
        p["w_gate"] = dense(*s, d, d_ff)
    p["w_up"] = dense(*s, d, d_ff)
    p["w_down"] = dense(*s, d_ff, d)
    if cfg.use_bias:
        p.update(b_up=zeros(*s, d_ff), b_down=zeros(*s, d))
    return p


def _moe_params(cfg: ArchConfig, s: tuple, dense, zeros):
    """The router in f32 at scale 0.006, the routed experts stacked on an
    (E,) dim, ``router_bias`` (f32 zeros) for the sigmoid router, and the
    shared experts as one gated MLP of n_shared * moe_d_ff."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p = {
        "router": dense(*s, d, E, scale=0.006, dt=torch.float32),
        "experts": {"w_gate": dense(*s, E, d, f), "w_up": dense(*s, E, d, f),
                    "w_down": dense(*s, E, f, d)},
    }
    if cfg.router_score == "sigmoid":
        p["router_bias"] = zeros(*s, E, dt=torch.float32)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": dense(*s, d, fs), "w_up": dense(*s, d, fs),
                       "w_down": dense(*s, fs, d)}
    return p


def _ssm_params(cfg: ArchConfig, s: tuple, dense, zeros, device):
    """The reference's ``_ssm_params`` leaves, stacked over s = (L,) or
    for one block s = ():
    projections and conv in ``cfg.dtype``, ``A_log``, ``D``, ``dt_bias``
    and ``ssm_norm`` in f32."""
    d, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_n_heads
    G, N, K = cfg.ssm_n_groups, cfg.ssm_d_state, cfg.ssm_d_conv
    conv_ch = d_in + 2 * G * N
    a_init, dt_init = _ssm_init(H)
    return {
        "in_z": dense(*s, d, d_in),
        "in_x": dense(*s, d, d_in),
        "in_B": dense(*s, d, G * N),
        "in_C": dense(*s, d, G * N),
        "in_dt": dense(*s, d, H),
        "conv_w": dense(*s, K, conv_ch, scale=0.1),
        "conv_b": zeros(*s, conv_ch),
        "A_log": a_init.repeat(*s, 1).to(device),
        "D": torch.ones(*s, H, device=device),
        "dt_bias": dt_init.repeat(*s, 1).to(device),
        "ssm_norm": zeros(*s, d_in, dt=torch.float32),
        "out_proj": dense(*s, d_in, d),
    }


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def shard_params(params, cfg: ArchConfig, mesh):
    """This rank's shards of a full parameter tree on the grid ``mesh``
    (``launch.mesh``): each leaf cut over the model axis by the rule table
    (``models.sharding.param_spec``, model entries only: FSDP over the
    data axis is not the port's yet), each shard a tensor of its own, so
    ``lm_from_jax`` then ``shard_params`` carries the reference's weights
    to every rank.  Where the axis divides the sharded dim the shard is
    the reference's NamedSharding shard, the rank's contiguous block; the
    layout departs from it at copied KV heads and at the SSM's conv
    channels (``models.sharding``'s docstring).  Raises where the heads,
    KV heads or experts of ``cfg`` do not split over the axis."""
    from repro_torch.models.sharding import (check_heads, leaf_index, take,
                                             tree_param_specs)
    m = mesh.shape.get("model", 1)
    if m == 1:
        return params
    check_heads(cfg, m)
    sizes, coords = {"model": m}, {"model": mesh.coord("model")}

    def walk(tree, specs, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k], f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        return take(tree, leaf_index(prefix, tree.shape, specs, cfg, sizes,
                                     coords))

    return walk(params, tree_param_specs(params, fsdp=False), "")
