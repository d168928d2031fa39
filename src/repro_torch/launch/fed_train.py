"""Federate an LM architecture through the device-resident engine;
counterpart of ``repro/launch/fed_train.py``.

Unlike ``launch/train.py`` (the seed host loop, resampling batches in
numpy every round), this CLI drives the production path: an ``LMTask``
(``fed/task.py``) puts each client's token stream on the device once, the
``RoundEngine`` runs multi-round spans with participation and batch
indices drawn on the device, and a ``StreamScheduler`` admits clients
that arrive mid-training into capacity slots: the machinery the logreg
workload uses, over the LM zoo.  A client-parallel round runs
``masked_sgd`` on every leaf and local step and reduces the deltas with
one ``weighted_agg`` launch on the card (``weighted_agg_quant`` with
``--compress int8``); a client-sequential one trains the slots one after
another into an f32 accumulator.

  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.fed_train --arch mamba2-130m \\
      --rounds 8 --clients 4 --mode client_sequential       # the card

The reference's flags at its defaults, plus ``--device`` (the CUDA device
unless ``cpu``).  The fleet, its token streams and the probe batch are the
reference's numpy draws from ``--seed``; the weights are the port's own
draw (``models.params.init_params``).  ``--chunk-size`` is accepted and
has no effect (the port runs a span's rounds one after another).
``--data N`` shards the client axis over the N ranks of a
``torch.distributed`` group the caller has initialised
(``fed.make_fed_sharding``), client-parallel only; ``--model``, ``--pod``
and a sharded client-sequential round wait for ROADMAP item 6.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.fed_step import unflatten_tree
from repro_torch.core.participation import TRACES
from repro_torch.device import resolve_device
from repro_torch.fed import (Arrival, Client, LMTask, StreamScheduler,
                             make_fed_sharding)
from repro_torch.models.params import param_count

ITEM_6 = "waits for model-sharded params and composite axes (ROADMAP item 6)"


def build_fleet(task, *, n_clients: int, samples: int, seed: int,
                n_domains: int = 4):
    """Seeded non-IID client fleet: Zipf token streams per domain, Table-2
    availability traces round-robin (the reference's arrays)."""
    rng = np.random.default_rng(seed)
    return [Client(x=task.token_stream(rng, n=samples, domain=i % n_domains),
                   trace=TRACES[i % len(TRACES)])
            for i in range(n_clients)]


def _sharding(args, mode: str):
    """The federation axis: None, or the ranks of the caller's group."""
    if args.model > 1 or args.pod:
        raise ValueError(f"--model {args.model} --pod {args.pod}: a model "
                         f"axis or a pod axis {ITEM_6}")
    if not args.data:
        return None
    if mode != "client_parallel":
        raise ValueError(f"--data {args.data} with --mode {mode}: the "
                         f"client-sequential round under sharding {ITEM_6}")
    sharding = make_fed_sharding()
    if sharding.n_shards != args.data:
        raise ValueError(f"--data {args.data}, but the process group has "
                         f"{sharding.n_shards} ranks")
    return sharding


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="mamba2-130m", choices=ARCH_IDS)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=None,
                    help="engine capacity slots (default: clients + 2)")
    ap.add_argument("--samples", type=int, default=24,
                    help="sequences per client")
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--scheme", default="C", choices=list("ABC"))
    ap.add_argument("--eta0", type=float, default=0.05)
    ap.add_argument("--mode", default=None,
                    choices=["client_parallel", "client_sequential"],
                    help="engine execution mode (default: the arch "
                         "config's fed.mode)")
    ap.add_argument("--agg", default="auto", choices=["auto", "tree", "flat"])
    ap.add_argument("--compress", default="none",
                    choices=["none", "bf16", "int8", "int8-topk"],
                    help="client-delta wire format for aggregation")
    ap.add_argument("--chunk-size", type=int, default=8,
                    help="the reference's scan chunk; accepted, no effect")
    ap.add_argument("--eval-every", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="full config (the card)")
    ap.add_argument("--data", type=int, default=0,
                    help="federation axis: the ranks of an initialised "
                         "torch.distributed group; 0 = unsharded")
    ap.add_argument("--model", type=int, default=1,
                    help="model axis (ROADMAP item 6; only 1)")
    ap.add_argument("--pod", type=int, default=0,
                    help="pod axis (ROADMAP item 6; only 0)")
    ap.add_argument("--arrive", type=int, default=0,
                    help="admit this many brand-new clients mid-run "
                         "(streaming arrivals at round rounds//2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    mode = args.mode or cfg.fed.mode
    device = resolve_device(args.device)
    sharding = _sharding(args, mode)

    task = LMTask(cfg, seq_len=args.seq, fsdp=(mode == "client_sequential"))
    clients = build_fleet(task, n_clients=args.clients,
                          samples=args.samples, seed=args.seed)
    params = task.init_params(args.seed, device=device)
    n_params = param_count(params)

    # probe loss: one fixed held-out batch of the first domain
    probe_rng = np.random.default_rng(args.seed + 1)
    probe = task.make_batch({"tokens": torch.from_numpy(task.token_stream(
        probe_rng, n=4, domain=0)).to(device)})

    def evaluate(p):
        with torch.no_grad():
            return (float(task.client_loss(unflatten_tree(p), probe)),
                    float("nan"))

    events = []
    if args.arrive:
        fresh = build_fleet(task, n_clients=args.arrive,
                            samples=args.samples, seed=args.seed + 999)
        events = [Arrival(max(1, args.rounds // 2), client=c)
                  for c in fresh]

    capacity = args.capacity
    if capacity is None:
        capacity = args.clients + max(2, args.arrive)
    sch = StreamScheduler(
        clients=clients, init_params=params, task=task,
        engine_mode=mode, capacity=capacity, max_samples=args.samples,
        local_epochs=args.local_epochs, batch_size=args.batch,
        scheme=args.scheme, eta0=args.eta0, chunk_size=args.chunk_size,
        agg=args.agg, compression=args.compress, sharding=sharding,
        seed=args.seed, mode="device", evaluate=evaluate, events=events,
        device=device)

    if not args.quiet:
        axis = (f"{sharding.n_shards} ranks" if sharding is not None
                else "single-device")
        print(f"arch={cfg.name} params={n_params:,} mode={mode} "
              f"scheme={args.scheme} C={args.clients} "
              f"E={args.local_epochs} B={args.batch} S={args.seq} "
              f"capacity={sch.engine.capacity} federation={axis} "
              f"wire={sch.engine.compression.name} device={device}")

    t0 = time.perf_counter()
    sch.run(args.rounds, eval_every=args.eval_every)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    evals = [(h.tau, h.loss, h.event) for h in sch.history
             if h.event or h.loss == h.loss]
    if not args.quiet:
        print("tau,probe_loss,event")
        for tau, loss, ev in evals:
            print(f"{tau},{loss:.4f},{ev}")
        print(f"rounds,{args.rounds}")
        print(f"wall_s,{wall:.2f}")
        print(f"rounds_per_sec,{args.rounds / wall:.3f}")

    losses = [l for _, l, _ in evals if l == l]
    return {"arch": cfg.name, "mode": mode, "params": n_params,
            "compression": sch.engine.compression.name,
            "rounds": args.rounds, "wall_s": round(wall, 3),
            "rounds_per_sec": round(args.rounds / wall, 3),
            "final_loss": losses[-1] if losses else float("nan"),
            "capacity": sch.engine.capacity,
            "events_applied": sch.events_applied}


if __name__ == "__main__":
    main(sys.argv[1:])
