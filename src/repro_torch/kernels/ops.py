"""Public wrappers over the port's kernels.

A wrapper launches its CUDA kernel for CUDA tensors and takes the plain
PyTorch version for CPU tensors, because they lie on the CPU; there is no
other fallback: a CUDA tensor goes through the kernel or the call raises.

``launches`` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels.  ``TOLERANCE`` holds the
tolerance of each kernel, per dtype of its data, against its plain version
on the card and against the reference's Pallas kernel in the CPU tests
(the reference suite's own values, ``tests/test_kernels.py:22-23``,
``:36``, ``:100-101``, ``:195-196`` and ``:222-228``); ``chip_smoke.py`` and
the tests read both from here.  ``weighted_agg_quant`` and its plain
version make the same roundings in the same order, so on the card the two
must be equal.  ``ssd_intra_chunk``'s bf16 entry is the reference suite's
for its sizes (Q up to 128); at a prefill's thousands of Q = 256 cells the
bf16 rounding of the scores alone can leave it, and ``chip_smoke.py``
holds the kernel there to that rounding's own bound.  The sharded forms'
entries are the reference's gate for its psum epilogue against the
single-device reduction, max abs error below 1e-4
(``tests/_sharded_check.py:74``).

``flash_attention`` and ``ssd_intra_chunk`` are forward-only, as the
reference's kernels are: their outputs carry no gradient, so each wrapper
raises, on the card and on the CPU alike, when grad mode is on and an input
requires grad (``taking_grad``), rather than hand back a tensor that would
silently cut its term out of a backward pass.  The models' training path
takes the differentiable plain forms instead, as the reference's does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import masked_sgd as _sgd
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import weighted_agg as _agg

launches: Dict[str, int] = {"weighted_agg": 0, "weighted_agg_quant": 0,
                            "weighted_agg_sharded": 0,
                            "weighted_agg_quant_sharded": 0,
                            "masked_sgd": 0, "flash_attention": 0,
                            "ssd_intra_chunk": 0}

TOLERANCE = {
    "weighted_agg": {torch.float32: dict(rtol=1e-6, atol=1e-5),
                     torch.bfloat16: dict(rtol=2e-2, atol=1e-5)},
    "weighted_agg_quant": {torch.int8: dict(rtol=1e-5, atol=1e-6)},
    # tests/_sharded_check.py:74
    "weighted_agg_sharded": {torch.float32: dict(rtol=0.0, atol=1e-4),
                             torch.bfloat16: dict(rtol=0.0, atol=1e-4)},
    "weighted_agg_quant_sharded": {torch.int8: dict(rtol=0.0, atol=1e-4)},
    "masked_sgd": {torch.float32: dict(rtol=1e-5, atol=1e-5),
                   torch.bfloat16: dict(rtol=2e-2, atol=1e-5)},
    "flash_attention": {torch.float32: dict(rtol=2e-5, atol=1e-5),
                        torch.bfloat16: dict(rtol=3e-2, atol=3e-2)},
    "ssd_intra_chunk": {torch.float32: dict(rtol=1e-5, atol=1e-5),
                        torch.bfloat16: dict(rtol=6e-2, atol=0.4)},
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def taking_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a function of ``tensors``: grad mode
    on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if taking_grad(*tensors):
        raise RuntimeError(
            f"{name} is forward-only (its kernel has no backward): call it "
            f"under torch.no_grad() or on tensors that require no grad; "
            f"training takes the differentiable plain path")


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} takes CUDA or CPU tensors, got {t.device}")


def weighted_agg(coeffs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """coeffs (K,) f32, deltas (K, D) f32 or bf16 -> (D,) f32 with
    out[d] = sum_k coeffs[k] * deltas[k, d], accumulated in f32."""
    _agg.check_args(coeffs, deltas)
    if not _on_card(deltas, "weighted_agg"):
        return _agg.weighted_agg_plain(coeffs, deltas)
    out = _agg.launch(coeffs, deltas)
    launches["weighted_agg"] += 1
    return out


def weighted_agg_quant(coeffs: torch.Tensor, payload: torch.Tensor,
                       scales: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """coeffs (K,) f32, payload (K, Dp) int8 and scales (K, Dp / chunk) f32
    (``core.compression.quantize_chunked``'s layout) -> (Dp,) f32 with
    out[d] = sum_k coeffs[k] * payload[k, d] * scales[k, d // chunk]: the
    codes dequantized and reduced without a (K, Dp) f32 buffer."""
    _agg.check_quant_args(coeffs, payload, scales, chunk)
    if not _on_card(payload, "weighted_agg_quant"):
        return _agg.weighted_agg_quant_plain(coeffs, payload, scales, chunk)
    out = _agg.launch_quant(coeffs, payload, scales, chunk)
    launches["weighted_agg_quant"] += 1
    return out


def weighted_agg_sharded(coeffs: torch.Tensor, deltas: torch.Tensor, *,
                         sharding) -> torch.Tensor:
    """coeffs (K/n,) f32 and deltas (K/n, D) f32 or bf16, this rank's
    slab of the client axis (``FedSharding.shard``) -> (D,) f32, the sum
    over every rank's clients of coeffs[k] * deltas[k, d], replicated."""
    _agg.check_args(coeffs, deltas)
    if not _on_card(deltas, "weighted_agg_sharded"):
        return _agg.weighted_agg_sharded_plain(coeffs, deltas, sharding)
    out = sharding.all_reduce(_agg.launch(coeffs, deltas))
    launches["weighted_agg_sharded"] += 1
    return out


def weighted_agg_quant_sharded(coeffs: torch.Tensor, payload: torch.Tensor,
                               scales: torch.Tensor, *, chunk: int,
                               sharding) -> torch.Tensor:
    """weighted_agg_quant on this rank's slab (coeffs (K/n,), payload
    (K/n, Dp) int8, scales (K/n, Dp / chunk) f32) -> (Dp,) f32 summed over
    the federation axis, replicated: only the f32 partial crosses ranks."""
    _agg.check_quant_args(coeffs, payload, scales, chunk)
    if not _on_card(payload, "weighted_agg_quant_sharded"):
        return _agg.weighted_agg_quant_sharded_plain(coeffs, payload, scales,
                                                     chunk, sharding)
    out = sharding.all_reduce(_agg.launch_quant(coeffs, payload, scales,
                                                chunk))
    launches["weighted_agg_quant_sharded"] += 1
    return out


def masked_sgd(w: torch.Tensor, g: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """w <- w - scale * g in f32, rounded to w's dtype, in place; returns w.
    w, g: (D,) with scale () or (1,), or (C, n) with scale (C,)."""
    _sgd.check_args(w, g, scale)
    if not _on_card(w, "masked_sgd"):
        return _sgd.masked_sgd_plain(w, g, scale)
    out = _sgd.launch(w, g, scale)
    launches["masked_sgd"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, KV, S, hd), f32 or bf16, H a multiple
    of KV (query head h reads KV head h // (H / KV)), hd 32, 64, 128 or
    256 ->
    (B, H, S, hd) softmax attention in q's dtype, scaled by 1/sqrt(hd),
    causal unless asked otherwise.  Raises under grad (forward-only)."""
    _flash.check_args(q, k, v)
    _forward_only("flash_attention", q, k, v)
    if not _on_card(q, "flash_attention"):
        return _flash.flash_attention_plain(q, k, v, causal)
    out = _flash.launch(q, k, v, causal)
    launches["flash_attention"] += 1
    return out


def ssd_intra_chunk(cum: torch.Tensor, C: torch.Tensor, B: torch.Tensor,
                    xdt: torch.Tensor) -> torch.Tensor:
    """cum (G, Q) f32, C and B (G, Q, N), xdt (G, Q, P) in f32 or bf16 ->
    (G, Q, P) f32: per cell ((C B^T) * L) xdt with L[i, j] = exp(cum[i] -
    cum[j]) for j <= i, else 0 (the SSD intra-chunk term).  The cells may
    also come as (Go, Gi), e.g. C and B expanded over the heads of a group
    with stride 0; the output is then (Go, Gi, Q, P).  Raises under grad
    (forward-only)."""
    _ssd.check_args(cum, C, B, xdt)
    _forward_only("ssd_intra_chunk", cum, C, B, xdt)
    if not _on_card(C, "ssd_intra_chunk"):
        return _ssd.ssd_intra_chunk_plain(cum, C, B, xdt)
    out = _ssd.launch(cum, C, B, xdt)
    launches["ssd_intra_chunk"] += 1
    return out
