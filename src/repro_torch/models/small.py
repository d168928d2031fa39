"""The paper's experiment models (McMahan et al. 2016 MLP/CNN and logistic
regression for SYNTHETIC), counterpart of ``repro/models/small.py``.

Every function here takes parameters with a leading client axis C and
inputs shaped (C, B, *input_shape): the C clients of a federated round run
as one batched computation, the written-out form of the reference's
``jax.vmap`` over clients.  A single model is the C = 1 case
(:func:`logits_small`).

Layout: the CNN runs in PyTorch's native NCHW with OIHW conv weights, and
``w1``'s 3136 rows are in (channel, row, col) order.  The reference keeps
NHWC activations with HWIO weights and ``w1`` rows in (row, col, channel)
order; ``repro_torch.params`` converts once between the two, so the forward
pass has no per-call permute.  Logistic regression and the MLP share the
reference's layout.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.paper import PaperModelConfig
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def init_small(cfg: PaperModelConfig, *, seed: int = 0,
               device=None) -> Params:
    """Fresh parameters in the port's layout, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (so every device gets the same
    values), with the reference's scales.  The values differ from the
    reference's ``jax.random`` init; tests convert the reference's
    parameters with ``repro_torch.params.from_jax`` instead."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std):
        return torch.randn(*shape, generator=gen) * std

    k = cfg.n_classes
    if cfg.kind == "logreg":
        d = cfg.input_shape[0]
        params = {"w": normal(d, k, std=0.01), "b": torch.zeros(k)}
    elif cfg.kind == "mlp":
        d, h = math.prod(cfg.input_shape), cfg.hidden
        params = {"w1": normal(d, h, std=math.sqrt(2.0 / d)),
                  "b1": torch.zeros(h),
                  "w2": normal(h, k, std=math.sqrt(2.0 / h)),
                  "b2": torch.zeros(k)}
    elif cfg.kind == "cnn":
        params = {"c1": normal(32, 1, 5, 5, std=0.1), "cb1": torch.zeros(32),
                  "c2": normal(64, 32, 5, 5, std=0.05),
                  "cb2": torch.zeros(64),
                  "w1": normal(64 * 7 * 7, 128, std=0.02),
                  "b1": torch.zeros(128),
                  "w2": normal(128, k, std=0.05), "b2": torch.zeros(k)}
    else:
        raise ValueError(cfg.kind)
    return {name: p.to(device) for name, p in params.items()}


def _conv_clients(h, w, b):
    """h (C, B, I, H, W); w (C, O, I, 5, 5); b (C, O) -> (C, B, O, H, W):
    each client's 5x5 filters over its own images, SAME padding.

    Written as im2col and one batched matmul for all C clients: the
    (C*B, I*25, H*W) patch matrix is a strided window view of the padded
    images made contiguous by one copy, and each client's (O, I*25)
    filter matrix is broadcast over its B images.  A grouped convolution
    with groups = C computes the same, but cuDNN runs it as one launch per
    group with layout transposes around each, and ``F.unfold`` launches
    one im2col kernel per image; this form launches a fixed number of
    kernels whatever C and B are, and its output is already the next
    layer's (C, B, O, H, W) layout."""
    C, B, I, H, W = h.shape
    O = w.shape[1]
    win = F.pad(h.reshape(C * B, I, H, W), (2, 2, 2, 2)).unfold(
        2, 5, 1).unfold(3, 5, 1)                   # (C*B, I, H, W, 5, 5)
    cols = win.permute(0, 1, 4, 5, 2, 3).reshape(C, B, I * 25, H * W)
    out = torch.matmul(w.reshape(C, 1, O, I * 25), cols)
    return (out + b[:, None, :, None]).view(C, B, O, H, W)


def _relu_pool(h):
    """ReLU, then 2x2 max pooling over each (H, W) plane of (C, B, O, H,
    W)."""
    C, B, O, H, W = h.shape
    h = F.max_pool2d(torch.relu(h).view(C * B, O, H, W), 2)
    return h.view(C, B, O, H // 2, W // 2)


def logits_clients(params: Params, cfg: PaperModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    """params with a leading client axis C; x (C, B, *input_shape) ->
    (C, B, n_classes)."""
    if cfg.kind == "logreg":
        # a broadcast product summed over the features, not a batched
        # GEMM: cuBLAS picks its GEMM kernel by the batch count, so one
        # client alone (the client-sequential round) would sum its logits
        # in another order than its row of the C-client product; this
        # reduction sums each client's in one order whatever C is
        return ((x[..., None] * params["w"][:, None]).sum(-2)
                + params["b"][:, None])
    if cfg.kind == "mlp":
        xf = x.reshape(*x.shape[:2], -1)
        h = torch.relu(torch.bmm(xf, params["w1"]) + params["b1"][:, None])
        return torch.bmm(h, params["w2"]) + params["b2"][:, None]
    if cfg.kind != "cnn":
        raise ValueError(cfg.kind)
    C, B = x.shape[:2]
    h = x.reshape(C, B, 1, 28, 28)
    h = _relu_pool(_conv_clients(h, params["c1"], params["cb1"]))
    h = _relu_pool(_conv_clients(h, params["c2"], params["cb2"]))
    # (channel, row, col) flatten order: w1's rows as params.from_jax
    # lays them out
    h = h.reshape(C, B, 64 * 7 * 7)
    h = torch.relu(torch.bmm(h, params["w1"]) + params["b1"][:, None])
    return torch.bmm(h, params["w2"]) + params["b2"][:, None]


def logits_small(params: Params, cfg: PaperModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """One model: params without a client axis; x (B, *input_shape)."""
    one = {name: p[None] for name, p in params.items()}
    return logits_clients(one, cfg, x[None])[0]


def make_loss_fn(cfg: PaperModelConfig):
    """loss_fn(params, batch) -> (C,): each client's mean cross-entropy on
    its batch {"x": (C, B, ...), "y": (C, B)}, with a leading client axis
    on params.  The clients' parameters are separate leaves of one graph,
    so the gradient of the summed losses is each client's own gradient."""

    def loss_fn(params: Params, batch) -> torch.Tensor:
        lg = logits_clients(params, cfg, batch["x"])
        ll = F.log_softmax(lg, dim=-1)
        # one-hot contraction, as the reference writes it
        oh = F.one_hot(batch["y"].long(), lg.shape[-1]).to(ll.dtype)
        return -(ll * oh).sum(-1).mean(-1)

    return loss_fn


def accuracy(params: Params, cfg: PaperModelConfig, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """One model's accuracy on (x, y): the count of correct predictions
    times the f32 reciprocal of their number, as the reference's mean
    rounds it (and a mean on CUDA; on the CPU ``mean`` divides, which can
    round the same count one ulp apart)."""
    return accuracy_of(logits_small(params, cfg, x), y)


def accuracy_of(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The accuracy of (n, classes) logits on (n,) labels (``accuracy``)."""
    return (logits.argmax(-1) == y).float().sum() * (1.0 / y.numel())
