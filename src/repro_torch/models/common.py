"""Shared model building blocks: norms, activations and the dense MLP,
counterpart of ``repro/models/common.py`` (the forward pass).

Norm scales are stored as offsets from one, ``y * (1 + scale)``, and
initialised to zero, as in the reference.  Statistics are taken in f32 and
the result is cast back to the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * rstd * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias=None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance (``jnp.var``'s)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps) * (1.0 + scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(x: torch.Tensor, p, cfg) -> torch.Tensor:
    """p is {"scale": ...} or {"scale": ..., "bias": ...}."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"], cfg.norm_eps)
    return layernorm(x, p["scale"], p.get("bias"), cfg.norm_eps)


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name in ("gelu", "geglu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: torch.relu(x).square()
    raise ValueError(f"unknown activation {name}")


def mlp_apply(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Dense FFN: gated (SwiGLU/GeGLU) or plain 2-matmul."""
    act = activation_fn(cfg.activation)
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        h = act(h)
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return y
