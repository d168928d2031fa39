"""Federated training driver for the LM architectures; counterpart of
``repro/launch/train.py``.

Trains a (reduced by default) architecture with the paper's
flexible-participation protocol on synthetic non-IID token streams: each
round draws every client's completed local steps from its participation
trace, weighs the clients by the scheme's coefficients and runs one
client-parallel round (E masked SGD steps per client through the
``masked_sgd`` kernel, the deltas reduced leaf by leaf, ``agg="tree"``)
at the staircase learning rate eta0 / tau.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --rounds 20 --scheme C [--full]                       # the card

The reference's flags, plus ``--device`` (the CUDA device unless ``cpu``).
The batches, the participation masks and vlm patch embeddings are the
reference's numpy draws from ``--seed`` (so equal arrays); the weights
are the port's own draw from ``--seed`` (``models.params.init_params``).
The gradients of the training loss are autograd's on the chunked
attention path: the flash and SSD kernels are forward-only and a training
round launches neither.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.arrivals import staircase_lr
from repro_torch.core.fed_step import (flatten_tree, make_fed_round,
                                       per_client_loss)
from repro_torch.core.participation import TRACES, sample_alpha
from repro_torch.data import fed_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.params import init_params, param_count


def round_batches(rng: np.random.Generator, cfg, tau: int, *, n_clients: int,
                  local_epochs: int, batch: int, seq: int) -> dict:
    """One round's batches as the reference's driver draws them, numpy
    arrays (C, E, b, ...): ``fed_lm_batches`` from ``rng``, and for a
    multimodal config N(0, 0.02) patch embeddings (C, E, b, P, d) from
    ``default_rng(tau)``."""
    out = fed_lm_batches(rng, vocab=cfg.vocab, n_clients=n_clients,
                         local_epochs=local_epochs, batch=batch, seq=seq,
                         codebooks=cfg.n_codebooks)
    if cfg.n_patches:
        out["patch_emb"] = 0.02 * np.random.default_rng(tau).normal(
            size=(n_clients, local_epochs, batch, cfg.n_patches, cfg.d_model)
        ).astype(np.float32)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scheme", default="C", choices=list("ABC"))
    ap.add_argument("--eta0", type=float, default=0.05)
    ap.add_argument("--full", action="store_true",
                    help="full config (needs a real accelerator)")
    ap.add_argument("--traces", type=int, default=5,
                    help="|T|: number of participation traces in play")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU; the CUDA device otherwise")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    C, E = args.clients, args.local_epochs
    rng = np.random.default_rng(args.seed)
    traces = [TRACES[i % args.traces] for i in range(C)]
    p_weights = torch.full((C,), 1.0 / C, device=device)

    params = init_params(cfg, seed=args.seed, device=device)
    print(f"arch={cfg.name} params={param_count(params):,} "
          f"C={C} E={E} scheme={args.scheme} on {device}")

    def loss_fn(p, b):
        return transformer.train_loss(p, cfg, b)

    round_fn = make_fed_round(per_client_loss(loss_fn), "client_parallel")
    flat = flatten_tree(params)     # the tree's tensors: updated in place
    losses, delta_norms, seconds = [], [], []
    for tau in range(args.rounds):
        t0 = time.perf_counter()
        alpha = sample_alpha(rng, traces, E)
        s = alpha.sum(axis=1)
        coeffs = scheme_coefficients(args.scheme, p_weights, s, E)
        batch = {k: torch.from_numpy(v).to(device) for k, v in round_batches(
            rng, cfg, tau, n_clients=C, local_epochs=E, batch=args.batch,
            seq=args.seq).items()}
        eta = staircase_lr(args.eta0, tau + 1)
        _, m = round_fn(flat, batch, torch.from_numpy(alpha).to(device),
                        coeffs, torch.tensor(eta, device=device),
                        with_metrics=True)
        # probe loss on client 0's first batch
        with torch.no_grad():
            loss = float(loss_fn(params, {k: v[0, 0]
                                          for k, v in batch.items()}))
        losses.append(loss)
        delta_norms.append(float(m["delta_norm"]))
        seconds.append(time.perf_counter() - t0)
        print(f"round {tau:3d} s={s.astype(int).tolist()} eta={eta:.4f} "
              f"loss={loss:.4f} |delta|={delta_norms[-1]:.3e} "
              f"({seconds[-1]:.1f}s)")

    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.rounds,
                        extra={"arch": cfg.name, "scheme": args.scheme})
        print(f"checkpoint -> {args.ckpt}")
    return dict(params=params, cfg=cfg, losses=losses,
                delta_norms=delta_norms, seconds=seconds)


if __name__ == "__main__":
    main()
