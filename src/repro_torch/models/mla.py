"""Multi-head Latent Attention (DeepSeek V2/V3, arXiv:2405.04434),
counterpart of ``repro/models/mla.py``.

Prefill runs the decompressed path: per-head k and v are materialised from
the compressed latent and attend through the chunked ``causal_attention``
(q and k at qk_nope + qk_rope, v at v_head_dim).  Decode runs the
*absorbed* path: queries are projected into the kv_lora latent space and
attention runs directly against the compressed cache, which holds only
(kv_lora + qk_rope) per token.  The reference's ``safe_concat`` (a GSPMD
workaround) is a plain ``torch.cat`` here.  As in ``attention``, the cache
is written in place and returned.

Under a model axis (``models.sharding``) w_uq (or wq), w_uk and w_uv are
split by heads and wo is row-parallel (one reduce); w_dq, w_dkv, their
norms and the latent cache are replicated, every rank writing the same
rows (the reference shards the cache's slots: a stated departure, since
every head reads every slot).  The replicated latents enter each rank's
heads through ``copy_to_model``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import scale_of
from repro_torch.models import attention
from repro_torch.models.attention import _mask_bias
from repro_torch.models.common import rmsnorm
from repro_torch.models.rotary import apply_rope
from repro_torch.models.sharding import (copy_to_model, model_axis,
                                         reduce_from_model)


def _project_q(p, x, cfg, positions, tp=None):
    B, S = x.shape[0], x.shape[1]
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(x @ p["w_dq"], p["q_ln"]["scale"], cfg.norm_eps)
        q = (copy_to_model(cq, tp) @ p["w_uq"]).reshape(B, S, -1, qk)
    else:
        q = (copy_to_model(x, tp) @ p["wq"]).reshape(B, S, -1, qk)
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _compress_kv(p, x, cfg, positions):
    ckv_full = x @ p["w_dkv"]                     # (B,S,kv_lora+rope)
    c_kv = rmsnorm(ckv_full[..., : cfg.kv_lora_rank], p["kv_ln"]["scale"],
                   cfg.norm_eps)
    k_rope = ckv_full[..., cfg.kv_lora_rank:]     # shared single rope head
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attention(p, x, cfg, positions, cache=None, decode=False, *,
                  reduce: bool = True):
    """Returns (out, cache_or_None).

    positions: (S,) int absolute positions of the rows of x (decode: (1,)).
    cache (per layer): {"ckv": (B,Slots,kv_lora), "krope": (B,Slots,rope),
    "pos_map": (Slots,)}, written in place and returned.  reduce: as
    ``attention.gqa_attention``'s.
    """
    B, S = x.shape[0], x.shape[1]
    tp = model_axis()
    q_nope, q_rope = _project_q(p, x, cfg, positions, tp)
    H = q_nope.shape[2]
    c_kv, k_rope = _compress_kv(p, x, cfg, positions)
    r = cfg.kv_lora_rank

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        slots = cache["ckv"].shape[1]
        slot = positions % slots       # a (1,) index: the write stays on
        cache["ckv"][:, slot] = c_kv   # the device
        cache["krope"][:, slot] = k_rope
        cache["pos_map"][slot] = positions.to(cache["pos_map"].dtype)
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        w_uk = p["w_uk"].reshape(r, H, cfg.qk_nope_dim)
        w_uv = p["w_uv"].reshape(r, H, cfg.v_head_dim)
        # absorbed path: q into latent space
        q_abs = torch.einsum("bthn,lhn->bthl", q_nope, w_uk)
        s = (torch.einsum("bthl,bsl->bhts", q_abs.float(), ckv_c.float())
             + torch.einsum("bthr,bsr->bhts", q_rope.float(), kr_c.float())) \
            * scale_of(cfg.qk_nope_dim + cfg.qk_rope_dim)
        pos_map = cache["pos_map"]
        valid = (pos_map >= 0) & (pos_map <= positions[0])
        s = s + _mask_bias(valid)
        w = torch.softmax(s, dim=-1).to(ckv_c.dtype)
        ctx = torch.einsum("bhts,bsl->bthl", w, ckv_c)
        o = torch.einsum("bthl,lhv->bthv", ctx, w_uv)
    else:
        # decompressed path
        c_kv_h = copy_to_model(c_kv, tp)
        k_nope = (c_kv_h @ p["w_uk"]).reshape(B, S, H, cfg.qk_nope_dim)
        v = (c_kv_h @ p["w_uv"]).reshape(B, S, H, cfg.v_head_dim)
        k_rope_h = copy_to_model(k_rope, tp)
        k = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(
            B, S, H, k_rope.shape[-1])], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        o = attention.causal_attention(q, k, v)
        if cache is not None:  # prefill
            cache["ckv"][:, positions] = c_kv
            cache["krope"][:, positions] = k_rope
            cache["pos_map"][positions] = positions.to(
                cache["pos_map"].dtype)
    out = o.reshape(B, S, H * cfg.v_head_dim) @ p["wo"]
    if tp is not None and reduce:
        out = reduce_from_model(out, tp)
    return out, cache
