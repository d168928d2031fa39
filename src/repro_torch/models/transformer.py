"""Top-level LM: embedding, the stacked layers, logits, prefill and decode;
counterpart of ``repro/models/transformer.py`` for serving.

The reference scans its stacked (L, ...) layer parameters with
``lax.scan``; here a Python loop indexes them layer by layer (views, no
copies).  The KV and SSM caches are written in place (see
``attention.gqa_attention`` and ``ssd.mamba_mixer``), so ``prefill`` and
``decode_step`` return the cache they were given.  The training loss and
multi-token prediction (whose parameters ``params.init_params`` makes) come
with the training slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import block_apply
from repro_torch.models.common import apply_norm
from repro_torch.models.params import block_kinds, check_ported, torch_dtype
from repro_torch.models.rotary import sinusoidal


# ---------------------------------------------------------------------------
# Embedding / heads
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ArchConfig, tokens, positions):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


def logits_fn(params, cfg: ArchConfig, h):
    """h: (..., d) -> logits (..., Vp) in f32, the products of h and the
    head summed in f32 (the reference's ``preferred_element_type``)."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return h.float() @ head.float()


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer i of a nested dict of stacked (L, ...) tensors, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def model_forward(params, cfg: ArchConfig, tokens, *, positions=None,
                  cache=None, decode=False):
    """Returns (hidden (B,S,d), aux_loss, cache_or_None): the stacks of
    ``block_kinds`` in turn, their blocks' aux losses summed.

    tokens: (B,S); decode: S == 1, positions: (1,) current position.
    """
    check_ported(cfg)
    S = tokens.shape[1]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x = embed_tokens(params, cfg, tokens, positions)
    total_aux = 0.0
    for name, kind, L in block_kinds(cfg):
        stack_cache = cache.get(name) if cache is not None else None
        for i in range(L):
            x, aux, _ = block_apply(
                _layer(params[name], i), x, cfg, kind, positions,
                cache=None if stack_cache is None else _layer(stack_cache, i),
                decode=decode)
            total_aux = total_aux + aux
    x = apply_norm(x, params["final_norm"], cfg)
    return x, total_aux, cache


# ---------------------------------------------------------------------------
# Serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Stacked per-layer caches on ``device`` (the CUDA device unless the
    CPU is asked for), one dict per stack of ``block_kinds``.  GQA
    attention: the kv dim flattened (KV*hd), ``pos_map`` -1 for empty
    slots, a ring buffer of ``sliding_window`` slots for SWA archs.  MLA:
    the compressed ``ckv`` and ``krope`` rows in ``max_len`` slots (no ring
    buffer).  SSM (alone or beside attention in the hybrid block): the last
    K-1 conv inputs (``cfg.dtype``) and the f32 state."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len

    def zeros(*shape, dt=dtype):
        return torch.zeros(*shape, dtype=dt, device=device)

    cache = {}
    for name, kind, L in block_kinds(cfg):
        c = {}
        if kind in ("dense", "moe", "hybrid") and cfg.n_heads:
            if cfg.use_mla:
                c["attn"] = {
                    "ckv": zeros(L, batch, max_len, cfg.kv_lora_rank),
                    "krope": zeros(L, batch, max_len, cfg.qk_rope_dim),
                    "pos_map": torch.full((L, max_len), -1, dtype=torch.int32,
                                          device=device),
                }
            else:
                width = cfg.n_kv_heads * cfg.head_dim
                c["attn"] = {
                    "k": zeros(L, batch, slots, width),
                    "v": zeros(L, batch, slots, width),
                    "pos_map": torch.full((L, slots), -1, dtype=torch.int32,
                                          device=device),
                }
        if kind in ("ssm", "hybrid"):
            G, N = cfg.ssm_n_groups, cfg.ssm_d_state
            hg = cfg.ssm_n_heads // G
            conv_ch = cfg.d_inner + 2 * G * N
            c["ssm"] = {
                "conv": zeros(L, batch, cfg.ssm_d_conv - 1, conv_ch),
                "state": zeros(L, batch, G, hg, cfg.ssm_head_dim, N,
                               dt=torch.float32),
            }
        cache[name] = c
    return cache


def prefill(params, cfg: ArchConfig, tokens, cache):
    """Run the prompt, fill the cache; returns (last-position logits
    (B,1,V), cache)."""
    h, _aux, cache = model_forward(params, cfg, tokens, cache=cache,
                                   decode=False)
    lg = logits_fn(params, cfg, h[:, -1:])[..., : cfg.vocab]
    return lg, cache


def decode_step(params, cfg: ArchConfig, cache, token, pos: int):
    """One decode step.  token: (B,1); pos: the absolute position.  Returns
    (logits (B,1,V), cache)."""
    # filled on the device: a copy from the host would wait for the card
    positions = torch.full((1,), pos, dtype=torch.long, device=token.device)
    h, _aux, cache = model_forward(params, cfg, token, positions=positions,
                                   cache=cache, decode=True)
    lg = logits_fn(params, cfg, h)[..., : cfg.vocab]
    return lg, cache
