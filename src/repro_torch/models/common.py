"""Shared model building blocks: norms, activations and the dense MLP,
counterpart of ``repro/models/common.py``.

Norm scales are stored as offsets from one, ``y * (1 + scale)``, and
initialised to zero, as in the reference.  Statistics are taken in f32 and
the result is cast back to the input's dtype.  ``rmsnorm`` carries the
reference's hand-written backward (its ``custom_vjp``); the other pieces
take autograd's, which follows the same casts as jax's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


class _RMSNorm(torch.autograd.Function):
    """The reference's ``custom_vjp``: f32 math inside, the saved input and
    the returned ``dx`` in x's dtype, ``dscale`` in scale's."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, rstd)
        return (x32 * rstd * (1.0 + scale.float())).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        x32, dy32 = x.float(), dy.float()
        xhat = x32 * rstd
        g = dy32 * (1.0 + scale.float())
        dscale = (dy32 * xhat).reshape(-1, dy.shape[-1]).sum(0)
        dx = rstd * (g - xhat * (g * xhat).mean(-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x, scale, eps)


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
