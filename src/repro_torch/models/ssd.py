"""Mamba2 SSD (state-space duality, arXiv:2405.21060), chunked form, and the
Mamba2 mixer; counterpart of ``repro/models/ssd.py``.

Prefill runs the chunked scan: within each chunk the quadratic "attention
dual" term, computed by the ``ssd_intra_chunk`` kernel (one launch per
call), and across chunks the recurrence over running states, which the
reference writes as a ``lax.scan`` and the port as a loop over the chunks.
The kernel is forward-only, so when gradients are being taken (grad mode
on and an input of the term requiring grad: a training step) the term is
the kernel's plain version ``ssd_intra_chunk_plain``, the reference
model's own differentiable einsum over ``exp(segsum)``, and the kernel is
not launched; the reference's training never runs its Pallas kernel
either.
Decode is the O(1) recurrence.  The reference's ``safe_concat`` (a GSPMD
workaround) is a plain ``torch.cat`` here.  With a cache, the mixer writes
the new conv inputs and state into the cache's tensors in place, as the
attention layers write their KV cache.

Under a model axis (``models.sharding``) each rank runs its own SSD heads:
in_z, in_x, the x channels of the conv, ssm_norm and out_proj are its
shards (out_proj row-parallel, one reduce); in_B, in_C, in_dt, A_log, D,
dt_bias and the conv's B and C channels are replicated, and the rank
slices out its heads' (and their group's) share after ``copy_to_model``.
The conv runs per channel over [x | B | C], so the rank's conv channels
are its x block followed by every B and C channel (the stated departure
from the rule table's contiguous block).  The gated rmsnorm over d_inner
adds the ranks' sums of squares before it divides.  Prefill launches
``ssd_intra_chunk`` on the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_plain
from repro_torch.models.common import rmsnorm
from repro_torch.models.sharding import (copy_to_model, model_axis,
                                         reduce_from_model)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) with out[i,j] = sum_{k=j+1..i} x[k]
    (j <= i), -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None, *, intra=None):
    """Chunked SSD scan.

    x:  (Bb, S, H, P)     head inputs
    dt: (Bb, S, H)        post-softplus step sizes
    A:  (H,)              negative decay rates
    B:  (Bb, S, G, N)     input  projections (G groups, H % G == 0)
    C:  (Bb, S, G, N)     output projections
    h0: (Bb, G, hg, P, N) optional initial state
    intra: the intra-chunk term, ``ops.ssd_intra_chunk``'s signature with
           the cells as (batch * chunks * groups, heads per group); by
           default ``ops.ssd_intra_chunk``, looked up at the call, or
           ``ssd_intra_chunk_plain`` when gradients are being taken
    Returns (y: (Bb,S,H,P), h_last: (Bb,G,hg,P,N) f32).
    """
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    hg = H // G
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q

    xr = x.reshape(Bb, nc, Q, G, hg, Pd).float()
    dtr = dt.reshape(Bb, nc, Q, G, hg).float()
    Br = B.reshape(Bb, nc, Q, G, N).float()
    Cr = C.reshape(Bb, nc, Q, G, N).float()

    dA = dtr * A.float().reshape(G, hg)                 # (Bb,nc,Q,G,hg)
    dA_cs = torch.cumsum(dA.permute(0, 1, 3, 4, 2), dim=-1)  # (Bb,nc,G,hg,Q)
    dA_sum = dA_cs[..., -1]                             # (Bb,nc,G,hg)
    xdt = xr * dtr[..., None]                           # (Bb,nc,Q,G,hg,P)

    # intra-chunk (the "quadratic / attention" dual form): one cell per
    # (batch, chunk, group, head); the group's B and C rows are read by its
    # heads through a stride-0 dim, xdt and the output through strides
    cells = Bb * nc * G
    terms = (
        dA_cs.reshape(cells, hg, Q),
        Cr.permute(0, 1, 3, 2, 4).reshape(cells, 1, Q, N).expand(-1, hg, Q, N),
        Br.permute(0, 1, 3, 2, 4).reshape(cells, 1, Q, N).expand(-1, hg, Q, N),
        xdt.permute(0, 1, 3, 4, 2, 5).reshape(cells, hg, Q, Pd))
    if intra is None:
        intra = ssd_intra_chunk_plain if kops.taking_grad(*terms) \
            else kops.ssd_intra_chunk
    y_intra = intra(*terms)
    y_intra = y_intra.reshape(Bb, nc, G, hg, Q, Pd).permute(0, 1, 4, 2, 3, 5)

    # chunk-final states
    decay_states = torch.exp(dA_sum[..., None] - dA_cs)     # (Bb,nc,G,hg,Q)
    x_decay = xdt * decay_states.permute(0, 1, 4, 2, 3)[..., None]
    states = torch.einsum("bcsgn,bcsghp->bcghpn", Br, x_decay)

    # inter-chunk recurrence over the running state h
    if h0 is None:
        h = torch.zeros(Bb, G, hg, Pd, N, device=x.device)
    else:
        h = h0.float()
    chunk_decay = torch.exp(dA_sum)                     # (Bb,nc,G,hg)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)               # (Bb,nc,G,hg,P,N)

    c_in_decay = torch.exp(dA_cs)                       # (Bb,nc,G,hg,Q)
    y_inter = torch.einsum("bcqgn,bcghpn->bcqghp", Cr, h_prevs) \
        * c_in_decay.permute(0, 1, 4, 2, 3)[..., None]

    y = (y_intra + y_inter).reshape(Bb, S, H, Pd)
    return y.to(x.dtype), h


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence.
    h: (Bb,G,hg,P,N); x_t: (Bb,H,P); dt_t: (Bb,H); B_t,C_t: (Bb,G,N)."""
    Bb, G, hg, Pd, N = h.shape
    xr = x_t.reshape(Bb, G, hg, Pd).float()
    dtr = dt_t.reshape(Bb, G, hg).float()
    dA = torch.exp(dtr * A.float().reshape(G, hg))
    h = h.float() * dA[..., None, None] + torch.einsum(
        "bgn,bghp->bghpn", B_t.float(), xr * dtr[..., None])
    y = torch.einsum("bgn,bghpn->bghp", C_t.float(), h)
    return y.reshape(Bb, x_t.shape[1], Pd).to(x_t.dtype), h


# ---------------------------------------------------------------------------
# Full Mamba2 mixer (in-proj, causal depthwise conv, SSD, gated norm, out)
# ---------------------------------------------------------------------------


def _causal_conv(xBC, w, b):
    """xBC: (Bb,S,Cc); w: (K,Cc); depthwise causal conv."""
    K = w.shape[0]
    S = xBC.shape[1]
    xp = F.pad(xBC, (0, 0, K - 1, 0))
    y = sum(xp[:, j:j + S] * w[j] for j in range(K))
    return y + b


def local_ssm_layout(cfg, m: int, rank: int = 0):
    """At m model ranks: (heads, groups, heads per group, first head, first
    group) of rank ``rank``'s SSD heads, a contiguous block that lies in
    one group or covers whole groups."""
    H, G = cfg.ssm_n_heads, cfg.ssm_n_groups
    hg = H // G
    if H % m:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not split over a "
                         f"model axis of {m} ranks")
    Hl = H // m
    if hg % Hl and Hl % hg:
        raise ValueError(f"{cfg.name}: {Hl} heads a rank straddle groups "
                         f"of {hg}")
    h0 = rank * Hl
    Gl = max(1, Hl // hg)
    return Hl, Gl, min(hg, Hl), h0, h0 // hg


def _sharded_gated_norm(v, scale, eps, d_full, tp):
    """rmsnorm over d_inner split over the model axis: each rank's sum of
    squares added over the axis (and, backward, the gradient of the
    replicated statistic summed back), then the rank's block normalised."""
    v32 = v.float()
    ss = reduce_from_model(v32.square().sum(-1, keepdim=True), tp)
    rstd = torch.rsqrt(copy_to_model(ss, tp) / d_full + eps)
    return (v32 * rstd * (1.0 + scale.float())).to(v.dtype)


def _tp_inputs(p, u, cfg, tp):
    """The mixer's inputs on the rank's heads: z, the pre-conv [x | B | C],
    dt, A and D, and the local group slice of B and C."""
    Hl, Gl, _, h0, g0 = local_ssm_layout(cfg, tp.size, tp.rank)
    ut = copy_to_model(u, tp)
    z = ut @ p["in_z"]
    xBC = torch.cat([ut @ p["in_x"], u @ p["in_B"], u @ p["in_C"]], dim=-1)
    dt = F.softplus((u @ p["in_dt"]).float() + p["dt_bias"].float())
    heads = slice(h0, h0 + Hl)
    dt = copy_to_model(dt, tp)[..., heads]
    A = -torch.exp(copy_to_model(p["A_log"], tp)[heads].float())
    D = copy_to_model(p["D"], tp)[heads]
    return z, xBC, dt, A, D, slice(g0, g0 + Gl)


def _local_groups(t, groups, G, N, tp):
    """(..., G*N) B or C rows -> the rank's groups, entering its heads."""
    if tp is None:
        return t
    t = t.reshape(*t.shape[:-1], G, N)[..., groups, :]
    return copy_to_model(t.reshape(*t.shape[:-2], -1), tp)


def mamba_mixer(p, u, cfg, cache=None, decode=False, *, intra=None):
    """Returns (out, cache_or_None).

    cache: {"conv": (Bb, K-1, Cc) raw pre-conv inputs,
            "state": (Bb, G, hg, P, N) f32}, written in place and returned.
    intra: the prefill's intra-chunk term (see ``ssd_chunked``).
    """
    d_in = p["in_x"].shape[1]
    Pd = cfg.ssm_head_dim
    H = d_in // Pd
    G, N = cfg.ssm_n_groups, cfg.ssm_d_state
    K = cfg.ssm_d_conv
    tp = model_axis()

    if tp is None:
        z = u @ p["in_z"]
        xBC = torch.cat([u @ p["in_x"], u @ p["in_B"], u @ p["in_C"]],
                        dim=-1)
        dt = F.softplus((u @ p["in_dt"]).float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        D, groups, Gl = p["D"], None, G
    else:
        z, xBC, dt, A, D, groups = _tp_inputs(p, u, cfg, tp)
        Gl = groups.stop - groups.start

    if decode:
        if cache is None:
            raise ValueError("decode needs a cache")
        conv_state = cache["conv"]  # (Bb, K-1, Cc)
        y_conv = (torch.einsum("bkc,kc->bc", conv_state, p["conv_w"][:K - 1])
                  + xBC[:, 0] * p["conv_w"][K - 1] + p["conv_b"])
        new_conv = torch.cat([conv_state[:, 1:], xBC], dim=1)
        xBC_act = F.silu(y_conv)[:, None, :]            # (Bb,1,Cc)
        x, B_, C_ = torch.split(xBC_act, [d_in, G * N, G * N], dim=-1)
        B_, C_ = (_local_groups(t, groups, G, N, tp) for t in (B_, C_))
        y, h = ssd_decode_step(
            cache["state"],
            x[:, 0].reshape(-1, H, Pd),
            dt[:, 0],
            A,
            B_[:, 0].reshape(-1, Gl, N),
            C_[:, 0].reshape(-1, Gl, N),
        )
        y = y[:, None]                                  # (Bb,1,H,P)
        x_skip = x.reshape(*x.shape[:2], H, Pd)
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(h)
    else:
        y_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"])
        xBC_act = F.silu(y_conv)
        x, B_, C_ = torch.split(xBC_act, [d_in, G * N, G * N], dim=-1)
        B_, C_ = (_local_groups(t, groups, G, N, tp) for t in (B_, C_))
        Bb, S = x.shape[0], x.shape[1]
        y, h = ssd_chunked(
            x.reshape(Bb, S, H, Pd), dt, A,
            B_.reshape(Bb, S, Gl, N), C_.reshape(Bb, S, Gl, N),
            cfg.ssm_chunk,
            h0=cache["state"] if cache is not None else None,
            intra=intra,
        )
        x_skip = x.reshape(Bb, S, H, Pd)
        if cache is not None:  # prefill
            cache["conv"].copy_(xBC[:, -(K - 1):, :])
            cache["state"].copy_(h)

    y = y + D.to(y.dtype)[:, None] * x_skip
    y = y.reshape(*y.shape[:2], d_in)
    if tp is None:
        y = rmsnorm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
        return y @ p["out_proj"], cache
    y = _sharded_gated_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps,
                            cfg.d_inner, tp)
    return reduce_from_model(y @ p["out_proj"], tp), cache
