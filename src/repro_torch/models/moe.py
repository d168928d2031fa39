"""Token-choice top-k MoE with capacity-bounded scatter dispatch,
counterpart of ``repro/models/moe.py``.

Router variants:
  softmax  (DeepSeek-V2): softmax scores, top-k renormalised.
  sigmoid  (DeepSeek-V3): sigmoid scores, selection uses score + learned
           bias (aux-loss-free balancing), gates renormalised over top-k.

The port has no device mesh, so ``moe_ffn`` is the reference's mesh-free
path (``_moe_ffn_dense``), which the reference also takes whenever no mesh
with a model axis is active, its ``ep=`` request included.  The
expert-parallel ``_moe_ffn_ep`` needs a model axis over several cards and
comes with the sharding slice.

The dispatch is the reference's: entry (t, j) of the flattened (T*k,)
top-k choices takes slot ``pos`` of its expert's buffer, pos being the
exclusive cumsum of the one-hot over the entries in token-major order (its
rank among the earlier entries of its expert, ``_rank_in_expert``), and
entries at pos >= cap overflow into a pad slot whose output is dropped.
The expert products are batched matmuls over E, as the reference leaves
them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation_fn, mlp_apply


def _capacity(T: int, k: int, E: int, factor: float) -> int:
    c = int(T * k / E * factor) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def _top_k(sel: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each f32 row in
    ``lax.top_k``'s order, which ``torch.topk`` does not promise: largest
    first under the floats' total order (XLA's: -0.0 below +0.0) and, among
    equal values, the lower index first.  A stable descending sort of the
    order-preserving int32 keys of the values."""
    bits = sel.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][:, :k]


def _rank_in_expert(fe: torch.Tensor, E: int) -> torch.Tensor:
    """Each entry's rank among the entries before it that chose the same
    expert: the reference's exclusive cumsum of the (T*k, E) one-hot down
    the entries, taken without the one-hot (whose scan down 98,304 rows
    took 37 ms a layer on the card).  A stable sort groups the entries by
    expert and keeps their order within a group, so an entry's place in the
    sorted order less its group's start is that rank, in integers."""
    n = fe.shape[0]
    order = torch.sort(fe, stable=True)[1]
    counts = torch.zeros(E, dtype=torch.long, device=fe.device).index_add_(
        0, fe, torch.ones(n, dtype=torch.long, device=fe.device))
    starts = counts.cumsum(0) - counts
    pos = torch.empty_like(fe)
    pos[order] = torch.arange(n, device=fe.device) - starts[fe[order]]
    return pos


def _routing(xf, p, cfg):
    """Shared router math: returns (top_i (T,k), gates (T,k), aux)."""
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"].float()
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p["router_bias"].float()[None, :] \
            if "router_bias" in p else scores
    else:
        scores = torch.softmax(logits, dim=-1)
        sel = scores
    top_i = _top_k(sel, k)
    top_s = torch.gather(scores, -1, top_i)
    gates = top_s / (top_s.sum(-1, keepdim=True) + 1e-9)
    if cfg.router_score == "sigmoid":
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-9)
    else:
        probs = scores
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(0)
    assign = torch.zeros(E, device=xf.device).index_add_(
        0, top_i.reshape(-1), torch.ones(T * k, device=xf.device))
    ce = assign / (T * k)
    aux = cfg.router_aux_coef * E * (me * ce).sum()
    return top_i, gates, aux


def moe_ffn(p, x, cfg):
    """x: (..., d) -> (..., d), plus the scalar aux loss (f32): the
    reference's mesh-free ``_moe_ffn_dense``.

    p: {"router": (d,E) [, "router_bias": (E,)],
        "experts": {"w_gate","w_up": (E,d,f), "w_down": (E,f,d)},
        ["shared": dense-mlp params]}
    """
    orig_shape = x.shape
    d = orig_shape[-1]
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    top_i, gates, aux = _routing(xf, p, cfg)

    # --- capacity-bounded scatter dispatch -------------------------------
    cap = _capacity(T, k, E, cfg.capacity_factor)
    fe = top_i.reshape(-1)                                 # (T*k,)
    pos = _rank_in_expert(fe, E)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)                     # overflow -> pad

    buf = torch.zeros(E, cap + 1, d, dtype=x.dtype, device=x.device)
    buf.index_put_((fe, slot), xf.repeat_interleave(k, dim=0),
                   accumulate=True)

    # --- expert FFN (batched over E) --------------------------------------
    act = activation_fn(cfg.activation)
    ex = p["experts"]
    h = act(torch.bmm(buf, ex["w_gate"])) * torch.bmm(buf, ex["w_up"])
    out_buf = torch.bmm(h, ex["w_down"])

    # --- gather + combine -------------------------------------------------
    y_tok = out_buf[fe, slot]                              # (T*k, d)
    y_tok = y_tok * (gates.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    y = y_tok.reshape(T, k, d).sum(1)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf, cfg)
    return y.reshape(orig_shape), aux
