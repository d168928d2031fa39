"""Parameters across the two packages: the reference's layout <-> the port's.

The paper models (``from_jax``, ``to_numpy``): the reference's CNN keeps
HWIO conv weights and ``w1`` rows in the NHWC flatten order (row, col,
channel); the port keeps OIHW conv weights and ``w1`` rows in NCHW order
(channel, row, col), so its forward pass runs in PyTorch's native layout
with no per-call permute.  These two functions own that conversion;
logistic regression and the MLP share one layout and pass through
unchanged.  ``reference_order`` gives the same conversion as a gather on
a flat parameter buffer, for the compressed wire, whose chunks must group
the elements the reference's chunks group.  Each takes the model's kind
from its config: the layout is a fact of the model, never read off the
parameters' names.

The LMs (``lm_from_jax``, ``lm_to_numpy``): the port keeps the reference's
layout as it is, nested dicts with per-layer leaves stacked on a leading
(L,) dim and head projections flattened as ``(d, H*hd)`` for ``x @ W``, so
the two functions only move arrays across (bf16 included, bit for bit).

Both sides are plain arrays: the port never imports the reference.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.paper import PaperModelConfig
from repro_torch.device import resolve_device

_POOLED = (7, 7, 64)      # the CNN's last activation, (row, col, channel)


def from_jax(params: Dict[str, np.ndarray], cfg: PaperModelConfig,
             device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's tensors on ``device``."""
    device = resolve_device(device)
    out = {}
    for name, a in params.items():
        a = np.asarray(a)
        if cfg.kind == "cnn" and name in ("c1", "c2"):
            a = a.transpose(3, 2, 0, 1)                # HWIO -> OIHW
        elif cfg.kind == "cnn" and name == "w1":
            a = a.reshape(*_POOLED, -1).transpose(2, 0, 1, 3).reshape(
                a.shape)                               # rows HWC -> CHW
        out[name] = torch.tensor(a, device=device)
    return out


def _to_reference(name: str, a: np.ndarray, kind: str) -> np.ndarray:
    """One leaf of the port's layout -> the reference's."""
    if kind == "cnn" and name in ("c1", "c2"):
        return a.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
    if kind == "cnn" and name == "w1":
        c, h, w = _POOLED[2], _POOLED[0], _POOLED[1]
        return a.reshape(c, h, w, -1).transpose(1, 2, 0, 3).reshape(
            a.shape)                                   # rows CHW -> HWC
    return a


def to_numpy(params: Dict[str, torch.Tensor],
             cfg: PaperModelConfig) -> Dict[str, np.ndarray]:
    """The port's parameters (or gradients, which share their layout) ->
    the reference's layout as numpy arrays."""
    return {name: np.ascontiguousarray(
                _to_reference(name, t.detach().cpu().numpy(), cfg.kind))
            for name, t in params.items()}


def reference_order(params: Mapping[str, torch.Tensor], kind: str):
    """The reference's element order of the flat (sorted-key, leaf-by-leaf)
    parameter buffer of a model of ``kind`` (``PaperModelConfig.kind``),
    in the port's buffer: ``flat[:, order]`` lays a (C, D) buffer of the
    port out as the reference lays out the same parameters, and
    ``ref_flat[..., inverse]`` takes it back.  Returns (order, inverse) as
    int64 tensors on the params' device, or None where the two layouts are
    one (every kind but the CNN).  Built once per model layout and
    device."""
    if kind != "cnn":
        return None
    layout = tuple((name, tuple(params[name].shape)) for name in
                   sorted(params))
    return _reference_order(layout, str(next(iter(params.values())).device))


@functools.lru_cache(maxsize=16)
def _reference_order(layout: Tuple[Tuple[str, Tuple[int, ...]], ...],
                     device: str):
    order, off = [], 0
    for name, shape in layout:
        n = int(np.prod(shape))
        idx = np.arange(off, off + n).reshape(shape)
        order.append(_to_reference(name, idx, "cnn").reshape(-1))
        off += n
    order = np.concatenate(order)
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.size)
    return torch.from_numpy(order).to(device), \
        torch.from_numpy(inverse).to(device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.array(a).view(np.uint16)) \
            .view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def lm_from_jax(params: Mapping, device=None) -> dict:
    """The reference's LM parameter tree (nested dicts of numpy arrays, or
    of anything ``np.asarray`` takes) -> the same tree of the port's
    tensors on ``device``, values and layout unchanged."""
    device = resolve_device(device)

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        return _tensor(np.asarray(tree), device)
    return walk(params)


def lm_to_numpy(params: Mapping) -> dict:
    """The port's LM parameter tree -> nested dicts of numpy arrays in the
    reference's layout.  bf16 tensors come back as f32 arrays holding the
    same values (numpy has no bf16 of its own)."""
    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return walk(params)
