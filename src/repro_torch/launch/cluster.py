"""Start one rank of a multi-process run, counterpart of
``repro/launch/cluster.py``.

The reference calls ``jax.distributed.initialize`` once per host and then
builds its production mesh over the global devices; here each rank is a
process: ``init_distributed`` joins it to the world
(``dist.init_process_group``), makes the card of its local rank current,
and the command after ``--`` runs in the same process (``runpy``, as the
reference runs it), where ``launch.mesh`` lays the grid over the world.

One line per rank (or let torchrun start them: with no coordinator, rank
and world size given, they are read from torchrun's environment,
``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, as the reference reads Cloud TPU's)::

    PYTHONPATH=src python -m repro_torch.launch.cluster \\
        --coordinator ${COORD_IP}:29500 \\
        --num-processes ${N_RANKS} --process-id ${RANK} \\
        -- python -m repro_torch.launch.fed_train --data 2 --model 2 ...

The backend is NCCL, the card's; gloo (CPU tensors, or CUDA tensors
through host memory) is taken only when ``--backend gloo`` names it.  A
coordinator is ``host:port`` (a ``tcp://`` init) or a ``file://`` path
shared by the ranks.  The local rank picks the card: rank r of a host
with n cards takes card r % n.  ``--axis-backends model=gloo,data=nccl``
gives the axes of the grids the command builds their own backends
(``launch.mesh.set_axis_backends``): one card cannot hold two NCCL ranks
of one communicator, so a model axis of ranks sharing a card runs on
gloo while each rank's federation axis stays NCCL.
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import parse_axis_backends, set_axis_backends

BACKENDS = ("nccl", "gloo")


def _init_method(coordinator: Optional[str]) -> str:
    if coordinator is None:
        for var in ("MASTER_ADDR", "MASTER_PORT"):
            if var not in os.environ:
                raise RuntimeError(
                    f"no coordinator given and {var} unset: pass "
                    f"coordinator= (host:port or file://...) or run under "
                    f"torchrun")
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"{name} unset: pass it, or run under torchrun")
    return int(os.environ[name])


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "nccl"):
    """Join this process to the world as rank ``process_id`` of
    ``num_processes`` over ``backend``, then make its local rank's card
    current where there is a card.  Omitted arguments come from torchrun's
    environment.  Returns ``torch.distributed``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        raise RuntimeError("the process group is initialised already")
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if torch.cuda.is_available():
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif backend == "nccl":
        raise RuntimeError("the NCCL backend needs a CUDA card; name "
                           "backend='gloo' for a CPU run")
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            rank=rank, world_size=world)
    return dist


def run_command(cmd: List[str]) -> None:
    """Run ``python -m module ...`` or ``python script.py ...`` in this
    process, its ``sys.argv`` the command's (the reference's hand-off)."""
    cmd = [c for c in cmd if c != "--"]
    if cmd and cmd[0] in ("python", "python3", sys.executable):
        cmd = cmd[1:]
    if not cmd:
        return
    if cmd[0] == "-m":
        sys.argv = cmd[1:]
        runpy.run_module(cmd[1], run_name="__main__", alter_sys=True)
    else:
        sys.argv = cmd
        runpy.run_path(cmd[0], run_name="__main__")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coordinator", default=os.environ.get(
        "REPRO_COORDINATOR"), help="host:port or file://path; default: "
        "$REPRO_COORDINATOR, else torchrun's MASTER_ADDR:MASTER_PORT")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default="nccl", choices=BACKENDS)
    ap.add_argument("--axis-backends", default=None,
                    help="axis=backend pairs for the grids' groups, e.g. "
                         "model=gloo,data=nccl (default: the world's)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- python -m repro_torch.launch.fed_train ...")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    set_axis_backends(parse_axis_backends(args.axis_backends))
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend)
    card = (f"cuda:{torch.cuda.current_device()}"
            if torch.cuda.is_available() else "cpu")
    print(f"[cluster] process {dist.get_rank()}/{dist.get_world_size()} "
          f"backend={dist.get_backend()} device={card}", flush=True)
    try:
        run_command(args.cmd)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
