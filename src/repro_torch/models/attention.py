"""GQA attention: chunked-causal prefill path, the flash_attention kernel's
prefill path, and the cached decode path; counterpart of
``repro/models/attention.py``.

The reference's sharding constraints are the identity without a mesh and
have no counterpart here.  Its ``_expand_kv`` (KV heads repeated to H so
that GSPMD shards one head axis) is not needed either: both paths read the
KV heads grouped, query head h reading KV head h // (H / KV), which is the
same arithmetic.

Under a model axis (``models.sharding``) each rank projects, attends and
caches its own query heads and the KV heads they read (a copy of one KV
head where the axis has more ranks than the model has KV heads, its
gradient summed over the ranks holding it), and ``wo`` is row-parallel:
one reduce, ``bo`` added after it.  Prefill with ``attn_impl="flash"``
launches the kernel on the rank's heads.  Cache writes are made in place in the cache's tensors,
where the reference returns updated copies: the cache of a full-size model
is gigabytes, and the caller's cache is the one the next step reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import scale_of
from repro_torch.models.rotary import apply_rope
from repro_torch.models.sharding import (copy_to_model, model_axis,
                                         reduce_from_model, sum_copies)

NEG_INF = -1e30


def _mask_bias(valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, 0.0, NEG_INF).float()


# ---------------------------------------------------------------------------
# Core: chunked causal attention (prefill)
# ---------------------------------------------------------------------------


def causal_attention(q, k, v, *, window: int = 0, q_offset=0,
                     chunk: int = 512):
    """q: (B,S,H,hd)  k,v: (B,S,KV,hd)  ->  (B,S,H,hd).

    Loops over query chunks; each chunk attends to the full key range under
    a causal (+ optional sliding-window) mask.  Scores in f32; the softmax
    weights are cast to v's dtype before their product with v.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    c = min(chunk, S)
    while S % c:
        c //= 2
    scale = scale_of(hd)
    k32 = k.float()
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i in range(S // c):
        q_chunk = q[:, i * c:(i + 1) * c].reshape(B, c, KV, g, hd)
        qpos = q_offset + i * c + torch.arange(c, device=q.device)
        s = torch.einsum("bckgd,bskd->bkgcs", q_chunk.float(), k32) * scale
        valid = kpos[None, :] <= qpos[:, None]
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        s = s + _mask_bias(valid)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgcs,bskd->bckgd", w, v))
    # note: v head dim may differ from q/k head dim (MLA)
    return torch.cat(outs, dim=1).reshape(B, S, H, v.shape[-1])


# ---------------------------------------------------------------------------
# Core: single-token decode against a (ring-buffer) cache
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos_map, pos, *, window: int = 0):
    """q: (B,1,H,hd); caches: (B,Slots,KV,hd); pos_map: (Slots,) absolute
    position held by each slot (-1 = empty)."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    g = H // KV
    s = torch.einsum("bckgd,bskd->bkgcs", q.reshape(B, 1, KV, g, hd).float(),
                     k_cache.float()) * scale_of(hd)
    valid = (pos_map >= 0) & (pos_map <= pos)
    if window:
        valid &= pos_map > pos - window
    s = s + _mask_bias(valid)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bkgcs,bskd->bckgd", w, v_cache)
    return o.reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# Projected GQA layer
# ---------------------------------------------------------------------------


def _kv_weights(p, cfg, tp):
    """wk, wv, bk, bv as this rank reads them: a copied KV head (model
    axis wider than the KV heads) has its gradient summed over the ranks
    holding it."""
    names = [n for n in ("wk", "wv", "bk", "bv") if n in p]
    KV = cfg.n_kv_heads
    if tp is None or KV % tp.size == 0:
        return {n: p[n] for n in names}
    slot = tp.rank // (tp.size // KV)
    return {n: sum_copies(p[n], p[n].ndim - 1, slot, KV, tp) for n in names}


def gqa_project_qkv(p, x, cfg, positions, tp=None):
    """Projections are stored flattened (d, H*hd); reshape to heads here
    (the rank's heads under a model axis ``tp``)."""
    B, S = x.shape[0], x.shape[1]
    hd = cfg.head_dim
    x = copy_to_model(x, tp)
    kv = _kv_weights(p, cfg, tp)
    q = x @ p["wq"]
    k = x @ kv["wk"]
    v = x @ kv["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + kv["bk"]
        v = v + kv["bv"]
    q = q.reshape(B, S, q.shape[-1] // hd, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(p, x, cfg, positions, cache=None, decode=False, *,
                  reduce: bool = True):
    """Full GQA block.  Returns (out, cache_or_None).

    positions: (S,) int absolute positions of the rows of x (decode: (1,)).
    cache (per layer): {"k": (B,Slots,KV*hd), "v": ..., "pos_map": (Slots,)},
    written in place and returned (KV the rank's under a model axis).
    reduce=False: under a model axis, the rank's partial output before the
    reduce and without ``bo`` (the parallel residual reduces it together
    with the FFN's).
    """
    tp = model_axis()
    q, k, v = gqa_project_qkv(p, x, cfg, positions, tp)
    B, S = q.shape[0], q.shape[1]
    KV, hd = k.shape[2], cfg.head_dim
    # caches store the kv dim flattened (KV*hd), as the reference's do
    unflat = lambda c: c.view(B, c.shape[1], KV, hd)
    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        slots = cache["k"].shape[1]
        # a (1,) index keeps the write on the device: a 0-d tensor index
        # would be read back to the host, a sync per layer and step
        slot = positions % slots
        cache["k"][:, slot] = k.reshape(B, 1, KV * hd)
        cache["v"][:, slot] = v.reshape(B, 1, KV * hd)
        cache["pos_map"][slot] = positions.to(cache["pos_map"].dtype)
        o = decode_attention(q, unflat(cache["k"]), unflat(cache["v"]),
                             cache["pos_map"], positions[0],
                             window=cfg.sliding_window)
    else:
        if cfg.attn_impl == "flash" and not cfg.sliding_window:
            # the flash_attention kernel (forward only: serving prefill);
            # its output is a view of a (B, S, H, hd) buffer
            o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2)).transpose(1, 2)
        else:
            o = causal_attention(q, k, v, window=cfg.sliding_window,
                                 q_offset=positions[0])
        if cache is not None:  # prefill: populate the (ring-buffer) cache
            slots = cache["k"].shape[1]
            keep = max(0, S - slots)  # ring buffer keeps the last `slots`
            write_slots = positions[keep:] % slots
            cache["k"][:, write_slots] = k[:, keep:].reshape(B, S - keep,
                                                             KV * hd)
            cache["v"][:, write_slots] = v[:, keep:].reshape(B, S - keep,
                                                             KV * hd)
            cache["pos_map"][write_slots] = positions[keep:].to(
                cache["pos_map"].dtype)
    out = o.reshape(B, S, -1) @ p["wo"]
    if tp is not None:
        if not reduce:
            return out, cache
        out = reduce_from_model(out, tp)
    if "bo" in p:
        out = out + p["bo"]
    return out, cache
