#!/usr/bin/env python3
"""The federated LM round of ``launch/train.py`` in both packages, free
running from one set of params: each round's probe loss and delta norm.

    PYTHONPATH=src python tools/train_drift.py [--layers 4] [--d-model 256]
        [--rounds 6] [--vocab 50280]

Run it from the root of a checkout, on the CPU; it imports JAX and the JAX
package (the reference) beside the port, as the port's tests do.  The
config is mamba2-130m's reduced one with its full vocabulary, SSD state
(N 128), head dim (64) and chunk (256), and ``--layers`` layers of
``--d-model``: the widths that set the training's behaviour, at a size
the CPU runs.  Both packages start from the reference's
``init_params(PRNGKey(0))`` (``lm_from_jax``) and take the same draws as
``launch/train.py`` at its defaults (seed 0: C 4, E 2, batch 2, seq 128,
scheme C, eta0 0.05 / tau, client 0's first batch as the probe).
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.core.aggregation import scheme_coefficients as jscheme
from repro.core.fed_step import make_fed_round as jmake_fed_round
from repro.core.participation import TRACES, sample_alpha
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.core.aggregation import scheme_coefficients
from repro_torch.core.fed_step import (flatten_tree, make_fed_round,
                                       per_client_loss)
from repro_torch.launch.train import round_batches
from repro_torch.models import transformer
from repro_torch.params import lm_from_jax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--vocab", type=int, default=50280)
    args = ap.parse_args(argv)
    changes = dict(vocab=args.vocab, n_layers=args.layers,
                   d_model=args.d_model, ssm_chunk=256, ssm_d_state=128,
                   ssm_head_dim=64)
    jcfg = dataclasses.replace(jget_config("mamba2-130m").reduced(),
                               **changes)
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(), **changes)
    C, E = 4, 2
    jparams = jax.jit(jinit_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                       jcfg)
    params = lm_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    flat = flatten_tree(params)
    jround = jax.jit(jmake_fed_round(
        lambda p, b: jtransformer.train_loss(p, jcfg, b), "client_parallel"))
    round_fn = make_fed_round(per_client_loss(
        lambda p, b: transformer.train_loss(p, cfg, b)), "client_parallel")
    rng = np.random.default_rng(0)
    traces = [TRACES[i % 5] for i in range(C)]
    for tau in range(args.rounds):
        alpha = sample_alpha(rng, traces, E)
        s = alpha.sum(axis=1)
        batch = round_batches(rng, cfg, tau, n_clients=C, local_epochs=E,
                              batch=2, seq=128)
        eta = 0.05 / (tau + 1)
        jparams, jm = jround(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(alpha), jscheme("C", jnp.full((C,), 1.0 / C),
                                        jnp.asarray(s), E), jnp.float32(eta))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, m = round_fn(flat, tb, torch.from_numpy(alpha),
                        scheme_coefficients("C", torch.full((C,), 1.0 / C),
                                            s, E),
                        torch.tensor(eta), with_metrics=True)
        jloss = float(jtransformer.train_loss(
            jparams, jcfg, {k: jnp.asarray(v[0, 0]) for k, v in
                            batch.items()}))
        with torch.no_grad():
            loss = float(transformer.train_loss(
                params, cfg, {k: v[0, 0] for k, v in tb.items()}))
        print(f"round {tau}: probe loss reference {jloss:.4f} port "
              f"{loss:.4f}; |delta| reference {float(jm['delta_norm']):.4f} "
              f"port {float(m['delta_norm']):.4f}", flush=True)


if __name__ == "__main__":
    main()
