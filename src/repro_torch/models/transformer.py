"""Top-level LM: embedding, the stacked layers, logits, the training loss,
prefill and decode; counterpart of ``repro/models/transformer.py``.

The reference scans its stacked (L, ...) layer parameters with
``lax.scan``; here a Python loop takes them layer by layer as views
(``unbind``, whose one backward node stacks the layers' gradients).  The
KV and SSM caches are written in place (see ``attention.gqa_attention``
and ``ssd.mamba_mixer``), so ``prefill`` and ``decode_step`` return the
cache they were given.

The audio family (``n_codebooks`` K) embeds (B, S, K) tokens as the sum
of K codebook embeddings and gives (..., K, V) logits; the multimodal
family prepends (B, P, d) patch embeddings in training and prefill, the
text at positions P and on.  ``init_cache`` does not count the patches:
a caller that prefills with them sizes the cache P + S + gen and decodes
at positions P + S + i (fewer slots make prefill keep only the last
ones, as a ring buffer would).

Under a model axis (``models.sharding``) the embedding and the head are
vocab-parallel: each rank looks up the tokens of its vocab block (zeros
for the others) and one reduce adds the ranks' rows, gemma's
``embed_scale`` applied after it; the head (the tied ``embed.T`` too)
gives each rank its block of the logits, gathered over the axis.
musicgen's (K, V, d) codebooks split their V the same way; llava's
patches pass through untouched.  ``init_cache`` sizes the rank's cache:
its KV heads, the replicated MLA latents, its SSM heads' conv channels
and state.

``train_loss`` is the reference's: cross-entropy over the text positions
in chunks (``chunked_xent``), plus 0.1 x the multi-token-prediction loss
where the config has one, plus the MoE aux loss.  Its gradients come from
autograd on the chunked attention path (``attn_impl="chunked"``, the
reference's training path); ``rmsnorm`` carries the reference's own
backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import block_apply
from repro_torch.models.common import apply_norm
from repro_torch.models.params import block_kinds, torch_dtype
from repro_torch.models.ssd import local_ssm_layout
from repro_torch.models.rotary import sinusoidal
from repro_torch.models.sharding import (copy_to_model, current_mesh,
                                         gather_from_model, local_kv_heads,
                                         model_axis, reduce_from_model,
                                         use_mesh)

LOSS_CHUNK = 512


# ---------------------------------------------------------------------------
# Embedding / heads
# ---------------------------------------------------------------------------


def embed_tokens(params, cfg: ArchConfig, tokens, positions):
    """tokens (B, S), or (B, S, K) for audio: the K codebook embeddings
    summed."""
    tp = model_axis()
    if tp is not None:
        x = _embed_vocab_parallel(params["embed"], cfg, tokens, tp)
    elif cfg.n_codebooks:
        x = sum(params["embed"][k][tokens[..., k]]
                for k in range(cfg.n_codebooks))
    else:
        x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal(positions, cfg.d_model).to(x.dtype)
    return x


def _embed_vocab_parallel(embed, cfg, tokens, tp):
    """The rank's vocab block looked up (its other tokens zero rows), the
    ranks' rows added by one reduce."""
    Vl = embed.shape[-2]
    lo = tp.rank * Vl

    def look(table, t):
        i = t.long() - lo
        ok = (i >= 0) & (i < Vl)
        return table[i.clamp(0, Vl - 1)] * ok[..., None].to(table.dtype)

    if cfg.n_codebooks:
        x = sum(look(embed[k], tokens[..., k])
                for k in range(cfg.n_codebooks))
    else:
        x = look(embed, tokens)
    return reduce_from_model(x, tp)


def logits_fn(params, cfg: ArchConfig, h):
    """h: (..., d) -> logits (..., Vp), audio (..., K, Vp), in f32, the
    products of h and the head summed in f32 (the reference's
    ``preferred_element_type``)."""
    head = params.get("lm_head")
    tp = model_axis()
    h = copy_to_model(h, tp)
    if cfg.n_codebooks:
        if head is None:
            head = params["embed"].transpose(1, 2)
        # the reference's contraction; a matmul would broadcast the (K,)
        # dim of the head against h's leading dims
        lg = torch.einsum("...d,kdv->...kv", h.float(), head.float())
    else:
        if head is None:
            head = params["embed"].T
        lg = h.float() @ head.float()
    return gather_from_model(lg, lg.ndim - 1, tp)


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer i of a nested dict of stacked (L, ...) tensors, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layers(tree, L: int):
    """The L layers of a nested dict of stacked (L, ...) tensors, as views
    (``unbind``: under autograd one node stacks the layers' gradients,
    where L selects would each make a zero-filled stack)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, L) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(L)]
    return tree.unbind(0)


def model_forward(params, cfg: ArchConfig, tokens, *, patch_emb=None,
                  positions=None, cache=None, decode=False):
    """Returns (hidden (B,S,d), aux_loss, cache_or_None): the stacks of
    ``block_kinds`` in turn, their blocks' aux losses summed.

    tokens: (B,S[,K]); decode: S == 1, positions: (1,) current position.
    patch_emb: (B,P,d) patch embeddings, prepended (train and prefill
    only), the hidden then (B, P+S, d).
    """
    S = tokens.shape[1]
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    if patch_emb is not None and not decode:
        Pn = patch_emb.shape[1]
        positions = torch.arange(Pn + S, device=tokens.device)
        x_text = embed_tokens(params, cfg, tokens, positions[Pn:])
        x = torch.cat([patch_emb.to(x_text.dtype), x_text], dim=1)
    else:
        x = embed_tokens(params, cfg, tokens, positions)
    total_aux = 0.0
    for name, kind, L in block_kinds(cfg):
        stack_cache = cache.get(name) if cache is not None else None
        for i, p_layer in enumerate(_layers(params[name], L)):
            x, aux, _ = block_apply(
                p_layer, x, cfg, kind, positions,
                cache=None if stack_cache is None else _layer(stack_cache, i),
                decode=decode)
            total_aux = total_aux + aux
    x = apply_norm(x, params["final_norm"], cfg)
    return x, total_aux, cache


# ---------------------------------------------------------------------------
# Training loss (chunked cross-entropy over the token axis)
# ---------------------------------------------------------------------------


def _xent_chunk(params, cfg, h_chunk, labels_chunk):
    """(summed loss, count of labels >= 0) of one chunk, in f32."""
    lg = logits_fn(params, cfg, h_chunk)          # (c[,K],Vp) f32
    if lg.shape[-1] != cfg.vocab:                 # mask padded vocab entries
        vmask = torch.arange(lg.shape[-1], device=lg.device) < cfg.vocab
        lg = torch.where(vmask, lg, -1e30)
    logz = torch.logsumexp(lg, dim=-1)
    valid = labels_chunk >= 0
    ll = torch.gather(lg, -1, labels_chunk.clamp(min=0).long()[..., None])
    per = (logz - ll[..., 0]) * valid
    return per.sum(), valid.sum().float()


def _xent_chunk_on(mesh, params, cfg, h_chunk, labels_chunk):
    """``_xent_chunk`` under the grid ``mesh``: the backward pass recomputes
    a chunk under the forward's grid even where it is taken after the
    grid's ``use_mesh`` has closed (the recomputed logits have the same
    shapes either way, so a recompute without the grid would go unseen)."""
    with use_mesh(mesh):
        return _xent_chunk(params, cfg, h_chunk, labels_chunk)


def chunked_xent(params, cfg, hidden2d, labels1d, chunk: int = LOSS_CHUNK):
    """hidden2d: (T,d); labels1d: (T[,K]).  -1 labels are masked.

    T is padded up to a multiple of the chunk with -1 labels, as the
    reference pads it; each chunk's logits are recomputed in the backward
    pass (the reference's ``jax.checkpoint``) when gradients are taken,
    under the grid of the forward.
    """
    T = hidden2d.shape[0]
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        hidden2d = torch.cat([hidden2d, hidden2d.new_zeros(
            pad, *hidden2d.shape[1:])])
        labels1d = torch.cat([labels1d, labels1d.new_full(
            (pad, *labels1d.shape[1:]), -1)])
        T += pad
    s = torch.zeros((), device=hidden2d.device)
    n = torch.zeros((), device=hidden2d.device)
    grad = torch.is_grad_enabled()
    for i in range(T // c):
        h, lab = hidden2d[i * c:(i + 1) * c], labels1d[i * c:(i + 1) * c]
        if grad:
            ds, dn = checkpoint(_xent_chunk_on, current_mesh(), params, cfg,
                                h, lab, use_reentrant=False)
        else:
            ds, dn = _xent_chunk(params, cfg, h, lab)
        s, n = s + ds, n + dn
    return s / torch.clamp(n, min=1.0)


def train_loss(params, cfg: ArchConfig, batch):
    """batch: {"tokens": (B,S[,K]), "labels": (B,S[,K])
               [, "patch_emb": (B,P,d)]}.  Returns the scalar loss."""
    tokens = batch["tokens"]
    labels = batch["labels"]
    patch_emb = batch.get("patch_emb")
    h, aux, _ = model_forward(params, cfg, tokens, patch_emb=patch_emb)
    if patch_emb is not None:
        h = h[:, patch_emb.shape[1]:]  # loss on text positions only
    B, S = labels.shape[0], labels.shape[1]
    loss = chunked_xent(params, cfg, h.reshape(B * S, -1),
                        labels.reshape(B * S, *labels.shape[2:]))
    if cfg.mtp_depth and "mtp" in params:
        loss = loss + 0.1 * _mtp_loss(params, cfg, h, tokens, labels)
    return loss + aux


def _mtp_loss(params, cfg, h, tokens, labels):
    """DeepSeek-V3 multi-token prediction (depth 1): predict t+2 from
    [norm(h_t); embed(token_{t+1})] through one extra block."""
    mtp = params["mtp"]
    S = tokens.shape[1]
    emb_next = embed_tokens(params, cfg, tokens[:, 1:],
                            torch.arange(1, S, device=tokens.device))
    h_in = torch.cat([apply_norm(h[:, :-1], mtp["norm"], cfg), emb_next],
                     dim=-1)
    x = h_in @ mtp["mtp_proj"]
    positions = torch.arange(x.shape[1], device=x.device)
    x, _aux, _ = block_apply(mtp["block"], x, cfg, "dense", positions)
    x = apply_norm(x, params["final_norm"], cfg)
    labels2 = labels[:, 1:]
    B, S2 = labels2.shape[0], labels2.shape[1]
    return chunked_xent(params, cfg, x.reshape(B * S2, -1),
                        labels2.reshape(B * S2, *labels2.shape[2:]))


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
    K-1 conv inputs (``cfg.dtype``) and the f32 state.  ``max_len`` counts
    every position the cache will hold, patches included.  On ``"meta"``:
    the shapes and dtypes alone."""
    device = resolve_device(device, meta=True)
    dtype = torch_dtype(cfg)
    slots = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    tp = model_axis()
    m = 1 if tp is None else tp.size

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
                width = (cfg.n_kv_heads if tp is None else
                         local_kv_heads(cfg, m)) * cfg.head_dim
                c["attn"] = {
                    "k": zeros(L, batch, slots, width),
                    "v": zeros(L, batch, slots, width),
                    "pos_map": torch.full((L, slots), -1, dtype=torch.int32,
                                          device=device),
                }
        if kind in ("ssm", "hybrid"):
            G, N = cfg.ssm_n_groups, cfg.ssm_d_state
            hg = cfg.ssm_n_heads // G
            Gl = G
            if tp is not None:
                _, Gl, hg, _, _ = local_ssm_layout(cfg, m)
            conv_ch = cfg.d_inner // m + 2 * G * N
            c["ssm"] = {
                "conv": zeros(L, batch, cfg.ssm_d_conv - 1, conv_ch),
                "state": zeros(L, batch, Gl, hg, cfg.ssm_head_dim, N,
                               dt=torch.float32),
            }
        cache[name] = c
    return cache


def prefill(params, cfg: ArchConfig, tokens, cache, *, patch_emb=None):
    """Run the prompt (after the patches, where given), fill the cache;
    returns (last-position logits (B,1[,K],V), cache)."""
    h, _aux, cache = model_forward(params, cfg, tokens, patch_emb=patch_emb,
                                   cache=cache, decode=False)
    lg = logits_fn(params, cfg, h[:, -1:])[..., : cfg.vocab]
    return lg, cache


def decode_step(params, cfg: ArchConfig, cache, token, pos: int):
    """One decode step.  token: (B,1[,K]); pos: the absolute position.
    Returns (logits (B,1[,K],V), cache)."""
    # filled on the device: a copy from the host would wait for the card
    positions = torch.full((1,), pos, dtype=torch.long, device=token.device)
    h, _aux, cache = model_forward(params, cfg, token, positions=positions,
                                   cache=cache, decode=True)
    lg = logits_fn(params, cfg, h)[..., : cfg.vocab]
    return lg, cache
