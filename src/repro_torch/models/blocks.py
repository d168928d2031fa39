"""Per-layer blocks, counterpart of ``repro/models/blocks.py``: the dense
block (GQA attention + MLP, sequential or parallel residual) and the SSM
block (Mamba2).  The MoE, hybrid and MLA blocks come with later slices of
the port."""
from __future__ import annotations

from repro_torch.models.attention import gqa_attention
from repro_torch.models.common import apply_norm, mlp_apply
from repro_torch.models.ssd import mamba_mixer


def block_apply(p, x, cfg, kind, positions, cache=None, decode=False):
    """Returns (x_out, aux_loss, cache_or_None); the cache is written in
    place (see ``attention.gqa_attention`` and ``ssd.mamba_mixer``)."""
    if kind not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{kind} blocks are not ported yet: the port runs dense GQA "
            f"and SSM blocks, the MoE, hybrid and MLA blocks come with "
            f"later slices")
    aux = 0.0                   # dense and SSM blocks have no auxiliary loss
    cache = cache or {}
    if kind == "ssm":
        h = apply_norm(x, p["ln1"], cfg)
        y, c = mamba_mixer(p["ssm"], h, cfg, cache=cache.get("ssm"),
                           decode=decode)
        return x + y, aux, ({"ssm": c} if c is not None else None)
    h = apply_norm(x, p["ln1"], cfg)
    a, ca = gqa_attention(p["attn"], h, cfg, positions, cache.get("attn"),
                          decode)
    if cfg.parallel_residual:
        x = x + a + mlp_apply(p["mlp"], h, cfg)
    else:
        x = x + a
        h2 = apply_norm(x, p["ln2"], cfg)
        x = x + mlp_apply(p["mlp"], h2, cfg)
    return x, aux, ({"attn": ca} if ca is not None else None)
