"""Per-layer blocks, counterpart of ``repro/models/blocks.py``: dense (GQA
or MLA attention + MLP, sequential or parallel residual), MoE (attention +
routed experts), SSM (Mamba2) and hybrid (parallel attention and SSM heads,
Hymba-style)."""
from __future__ import annotations

from repro_torch.models.attention import gqa_attention
from repro_torch.models.common import apply_norm, mlp_apply, rmsnorm
from repro_torch.models.mla import mla_attention
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssd import mamba_mixer


def _attn(p, x, cfg, positions, cache, decode):
    if cfg.use_mla:
        return mla_attention(p, x, cfg, positions, cache=cache, decode=decode)
    return gqa_attention(p, x, cfg, positions, cache=cache, decode=decode)


def block_apply(p, x, cfg, kind, positions, cache=None, decode=False):
    """Returns (x_out, aux_loss, cache_or_None); the cache is written in
    place (see ``attention.gqa_attention``, ``mla.mla_attention`` and
    ``ssd.mamba_mixer``).  The aux loss is the MoE router's, 0.0 for the
    other kinds."""
    aux = 0.0
    new_cache = {}
    cache = cache or {}

    if kind == "ssm":
        h = apply_norm(x, p["ln1"], cfg)
        y, c = mamba_mixer(p["ssm"], h, cfg, cache=cache.get("ssm"),
                           decode=decode)
        if c is not None:
            new_cache["ssm"] = c
        x = x + y

    elif kind == "hybrid":
        h = apply_norm(x, p["ln1"], cfg)
        a, ca = _attn(p["attn"], h, cfg, positions, cache.get("attn"), decode)
        s, cs = mamba_mixer(p["ssm"], h, cfg, cache=cache.get("ssm"),
                            decode=decode)
        if ca is not None:
            new_cache["attn"] = ca
        if cs is not None:
            new_cache["ssm"] = cs
        # Hymba: per-branch norm, mean combine
        y = 0.5 * (rmsnorm(a, p["ln_a"]["scale"], cfg.norm_eps)
                   + rmsnorm(s, p["ln_s"]["scale"], cfg.norm_eps))
        x = x + y
        h2 = apply_norm(x, p["ln2"], cfg)
        x = x + mlp_apply(p["mlp"], h2, cfg)

    elif kind == "moe":
        h = apply_norm(x, p["ln1"], cfg)
        a, ca = _attn(p["attn"], h, cfg, positions, cache.get("attn"), decode)
        if ca is not None:
            new_cache["attn"] = ca
        x = x + a
        h2 = apply_norm(x, p["ln2"], cfg)
        y, aux_moe = moe_ffn(p["moe"], h2, cfg)
        aux = aux + aux_moe
        x = x + y

    elif kind == "dense":
        h = apply_norm(x, p["ln1"], cfg)
        a, ca = _attn(p["attn"], h, cfg, positions, cache.get("attn"), decode)
        if ca is not None:
            new_cache["attn"] = ca
        if cfg.parallel_residual:
            x = x + a + mlp_apply(p["mlp"], h, cfg)
        else:
            x = x + a
            h2 = apply_norm(x, p["ln2"], cfg)
            x = x + mlp_apply(p["mlp"], h2, cfg)

    else:
        raise ValueError(f"unknown block kind {kind!r}")

    return x, aux, (new_cache or None)
