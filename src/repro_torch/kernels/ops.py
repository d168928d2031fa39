"""Public wrappers over the port's kernels.

A wrapper launches its CUDA kernel for CUDA tensors and takes the plain
PyTorch version for CPU tensors, because they lie on the CPU; there is no
other fallback: a CUDA tensor goes through the kernel or the call raises.

``launches`` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its path went through the kernels.  ``TOLERANCE`` holds the
tolerance of each kernel, per dtype of its data, against its plain version
on the card and against the reference's Pallas kernel in the CPU tests
(the reference suite's own values, ``tests/test_kernels.py:22-23`` and
``:36``); ``chip_smoke.py`` and the tests read both from here.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import masked_sgd as _sgd
from repro_torch.kernels import weighted_agg as _agg

launches: Dict[str, int] = {"weighted_agg": 0, "masked_sgd": 0}

TOLERANCE = {
    "weighted_agg": {torch.float32: dict(rtol=1e-6, atol=1e-5),
                     torch.bfloat16: dict(rtol=2e-2, atol=1e-5)},
    "masked_sgd": {torch.float32: dict(rtol=1e-5, atol=1e-5),
                   torch.bfloat16: dict(rtol=2e-2, atol=1e-5)},
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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
