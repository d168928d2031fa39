#!/usr/bin/env python3
"""Does a client's arithmetic depend on how many clients share the launch?

    python3 tools/batch_invariance.py [--device cpu]

Run it from the root of a checkout.  The client-sequential round trains
one client at a time (C = 1 of the batched local step) and equals the
client-parallel round bit for bit only where one client's local steps
equal its row of the C-client steps.  For each paper model and a few C,
this prints how many elements of the one-client results differ from their
rows: the local steps (``core.fed_step.local_sgd``, E 3, B 10, eta 0.5),
one step's gradients, and the products the models run (the batched GEMM
x @ w, its two backward products x^T @ g and g @ w^T, and the logreg
forward's broadcast product summed over the features); then the time of
the logreg step's forward and backward in both forms on the device.  The
last line is one JSON object with every count.  On the CUDA device unless
``--device cpu``.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs.paper import (EMNIST_CNN, MNIST_MLP,  # noqa: E402
                                       SYNTHETIC_LR)
from repro_torch.core.fed_step import local_sgd  # noqa: E402
from repro_torch.models.small import init_small, make_loss_fn  # noqa: E402

# (model, clients): the reference's scenario, the tables' and the main
# path's federations
LOCAL = [(SYNTHETIC_LR, 4), (SYNTHETIC_LR, 24), (MNIST_MLP, 24),
         (EMNIST_CNN, 62)]
# (C, B, K, N) of the products: logreg (B 10 and 20), the MLP's layers
PRODUCTS = [(C, B, K, N) for C in (4, 24, 62)
            for B, K, N in ((10, 60, 10), (20, 60, 10), (10, 784, 200),
                            (10, 200, 10))]


def differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose f32 bits differ."""
    return int((a.float().contiguous().view(torch.int32)
                != b.float().contiguous().view(torch.int32)).sum())


def rows_vs_alone(fn, *args) -> int:
    """fn on all C rows at once against fn on each row alone."""
    whole = fn(*args)
    alone = torch.cat([fn(*(a[c:c + 1] for a in args))
                       for c in range(args[0].shape[0])])
    return differing(whole, alone)


def device_us(fn, dev, n: int = 100) -> float:
    if dev.type != "cuda":
        return float("nan")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    dev = resolve_device(ap.parse_args().device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"products": {}, "local_sgd": {}, "grads": {}}
    for C, B, K, N in PRODUCTS:
        x = torch.randn(C, B, K, device=dev, generator=gen)
        w = torch.randn(C, K, N, device=dev, generator=gen)
        g = torch.randn(C, B, N, device=dev, generator=gen)
        counts = {
            "x @ w": rows_vs_alone(torch.bmm, x, w),
            "x^T @ g": rows_vs_alone(
                lambda a, b: torch.bmm(a.transpose(1, 2), b), x, g),
            "g @ w^T": rows_vs_alone(
                lambda a, b: torch.bmm(a, b.transpose(1, 2)), g, w),
            "broadcast sum": rows_vs_alone(
                lambda a, b: (a[..., None] * b[:, None]).sum(-2), x, w)}
        out["products"][f"C={C} B={B} K={K} N={N}"] = counts
        print(f"C={C} (B, K, N)=({B}, {K}, {N}): elements differing, rows "
              f"against each client alone: {counts}", flush=True)
    for cfg, C in LOCAL:
        params = init_small(cfg, seed=0, device=dev)
        E, B = 3, 10
        x = torch.randn(C, E, B, *cfg.input_shape, device=dev, generator=gen)
        y = torch.randint(0, cfg.n_classes, (C, E, B), device=dev,
                          generator=gen)
        alpha = torch.ones(C, E, device=dev)
        eta = torch.tensor(0.5, device=dev)
        loss = make_loss_fn(cfg)
        whole = local_sgd(loss, params, {"x": x, "y": y}, alpha, eta)
        alone = [local_sgd(loss, params, {"x": x[c:c + 1], "y": y[c:c + 1]},
                           alpha[c:c + 1], eta) for c in range(C)]
        counts = {k: differing(whole[k], torch.cat([a[k] for a in alone]))
                  for k in whole}
        with torch.enable_grad():
            w = {k: v.expand(C, *v.shape).clone().requires_grad_()
                 for k, v in params.items()}
            gw = torch.autograd.grad(loss(w, {"x": x[:, 0], "y": y[:, 0]})
                                     .sum(), list(w.values()))
            ga = []
            for c in range(C):
                w1 = {k: v[None].clone().requires_grad_()
                      for k, v in params.items()}
                ga.append(torch.autograd.grad(
                    loss(w1, {"x": x[c:c + 1, 0], "y": y[c:c + 1, 0]}).sum(),
                    list(w1.values())))
        grads = {k: differing(gw[i], torch.cat([a[i] for a in ga]))
                 for i, k in enumerate(w)}
        out["local_sgd"][f"{cfg.kind} C={C}"] = counts
        out["grads"][f"{cfg.kind} C={C}"] = grads
        print(f"{cfg.kind}, C={C}: elements differing, each client's local "
              f"steps alone against its row: {counts}; one step's "
              f"gradients: {grads}", flush=True)
    C, B = 24, 20
    x = torch.randn(C, B, 60, device=dev, generator=gen)
    w = torch.randn(C, 60, 10, device=dev, generator=gen, requires_grad=True)

    def step(f):
        def run():
            with torch.enable_grad():
                return torch.autograd.grad(f(x, w).sum(), [w])
        return run
    out["logreg_step_us"] = {
        "x @ w": device_us(step(torch.bmm), dev),
        "broadcast sum": device_us(
            step(lambda a, b: (a[..., None] * b[:, None]).sum(-2)), dev)}
    print(f"logreg forward and backward at (C, B) = ({C}, {B}), device "
          f"time: {out['logreg_step_us']} us", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
