"""Rotary and sinusoidal position embeddings, counterpart of
``repro/models/rotary.py``.  RoPE rotates split halves of the head dim,
``[x1 cos - x2 sin, x2 cos + x1 sin]``, not interleaved pairs."""
from __future__ import annotations

import math

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(..., S) -> (..., S, d) classic transformer sinusoids."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
