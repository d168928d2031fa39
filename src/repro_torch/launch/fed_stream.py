"""Run a named streaming-participation scenario end to end.

  PYTHONPATH=src python -m repro_torch.launch.fed_stream --scenario flash-crowd
  PYTHONPATH=src python -m repro_torch.launch.fed_stream --scenario churn \\
      --rounds 60 --eval-every 10 --mode plan --json out.json --device cpu

Counterpart of ``repro/launch/fed_stream.py``.  Replays the scenario's
event stream (arrivals admitted into capacity slots mid-training,
departures, trace shifts, inactivity bursts) through the StreamScheduler
on the paper's SYNTHETIC logreg workload, on the CUDA device unless
``--device cpu``, and prints an honest summary (rounds without an eval are
NaN and are filtered, see ``fed.scenarios.summarize_history``) plus
wall-clock rounds/sec.  ``--save-state`` and ``--restore`` write and read
the reference's checkpoint files, so either package resumes the other's.
``--bank`` keeps the fleet's payloads in a host-RAM client bank and
``--prefetch`` (implies it) stages each boundary's arrival cohort onto the
device while the span before it runs (``fed/bank.py``; on the card from
pinned memory on a CUDA stream of its own); the summary's ``"bank"``
entry holds the bank's and the stager's counters.  ``--metrics-out``
(telemetry JSONL: spans, then a metrics snapshot) and ``--prom-out`` (the
Prometheus text exposition) turn telemetry on (``repro_torch.obs``);
span times are the host's, the card's work being asynchronous.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.fed.scenarios import SCENARIOS, make_scenario, run_scenario

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="flash-crowd",
                    choices=sorted(SCENARIOS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=None,
                    help="override the scenario's round count")
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--mode", default=None, choices=["device", "plan"],
                    help="sampling mode (default: device; with --restore "
                         "the checkpoint's own mode unless given "
                         "explicitly: overriding it breaks exact resume)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="the reference's scan chunk; accepted, no effect")
    ap.add_argument("--compress", default=None,
                    choices=["none", "bf16", "int8", "int8-topk"],
                    help="client-delta wire format (default: none; with "
                         "--restore the checkpoint's own format unless "
                         "given explicitly)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the CUDA device")
    ap.add_argument("--bank", action="store_true",
                    help="keep the full fleet's payloads in a host-RAM "
                         "client bank (fed/bank.py); capacity slots "
                         "become a managed hot cache")
    ap.add_argument("--prefetch", action="store_true",
                    help="double-buffered cohort prefetch: stage the "
                         "next boundary's arrival cohort onto the "
                         "device while the current span runs "
                         "(implies --bank)")
    ap.add_argument("--json", default=None,
                    help="also write the summary to this path")
    ap.add_argument("--save-state", default=None, metavar="DIR",
                    help="write a resumable checkpoint (params + FedState "
                         "+ history) when the run ends")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="resume a --save-state checkpoint (of either "
                         "package) and run --rounds more rounds")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the telemetry JSONL dump (spans + "
                         "metrics) here when the run ends (enables "
                         "telemetry)")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition here "
                         "when the run ends (enables telemetry)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    telemetry = None
    if args.metrics_out or args.prom_out:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry()

    device = resolve_device(args.device)
    sc = make_scenario(args.scenario, seed=args.seed)
    t0 = time.perf_counter()
    if args.restore:
        from repro_torch.configs.paper import SYNTHETIC_LR
        from repro_torch.fed.scenarios import _paper_eval_fn, summarize_history
        from repro_torch.fed.stream import StreamScheduler
        from repro_torch.models.small import make_loss_fn
        # the checkpoint's own mode and wire unless given explicitly
        # (argparse's default must not silently flip a plan checkpoint to
        # device sampling: that would break exact resume)
        overrides = {} if args.mode is None else {"mode": args.mode}
        if args.compress is not None:
            overrides["compression"] = args.compress
        if args.bank:
            overrides["bank"] = True
        if args.prefetch:
            overrides["prefetch"] = True
        sch = StreamScheduler.restore(args.restore,
                                      loss_fn=make_loss_fn(SYNTHETIC_LR),
                                      eval_fn=_paper_eval_fn(),
                                      model_kind=SYNTHETIC_LR.kind,
                                      device=device, telemetry=telemetry,
                                      **overrides)
        resumed_from = sch._next_tau
        sch.run(args.rounds if args.rounds is not None else sc.n_rounds,
                eval_every=(args.eval_every if args.eval_every is not None
                            else sc.eval_every))
        summary = summarize_history(sch.history)
        summary.update(scenario=sc.name, events_applied=sch.events_applied,
                       capacity=sch.engine.capacity,
                       clients_end=len(sch.clients),
                       resumed_from=resumed_from)
        rounds_ran = sch._next_tau - resumed_from
    else:
        sch, summary = run_scenario(sc, mode=args.mode or "device",
                                    n_rounds=args.rounds,
                                    eval_every=args.eval_every,
                                    chunk_size=args.chunk_size,
                                    compression=args.compress,
                                    bank=args.bank or None,
                                    prefetch=args.prefetch,
                                    telemetry=telemetry, device=device)
        rounds_ran = summary["rounds"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    # the run is over: no staging thread outlives it
    sch.close()
    if telemetry is not None:
        if args.metrics_out:
            telemetry.dump_jsonl(args.metrics_out)
            if not args.quiet:
                print(f"# telemetry JSONL written to {args.metrics_out}")
        if args.prom_out:
            telemetry.write_prom(args.prom_out)
            if not args.quiet:
                print(f"# prom exposition written to {args.prom_out}")
    if args.save_state:
        sch.save(args.save_state)
        if not args.quiet:
            print(f"# resumable checkpoint written to {args.save_state}")
    summary["compression"] = sch.engine.compression.name
    if sch.bank is not None:
        summary["bank"] = sch.prefetch_stats()
    summary["wall_s"] = round(wall, 3)
    # rounds run in this invocation (a resumed history also holds the
    # rounds before the checkpoint, which this wall clock never paid for)
    summary["rounds_per_sec"] = round(rounds_ran / wall, 2)

    if not args.quiet:
        where = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
        print(f"# device {where}")
        print(f"# scenario {sc.name} ({sc.notes}), seed {sc.seed}, "
              f"mode {sch.mode}, wire {sch.engine.compression.name}")
        if sch.bank is not None:
            ps = sch.prefetch_stats()
            print(f"# bank: {ps['bank']['resident']} resident, "
                  f"prefetch hits {ps.get('hits', 0)} "
                  f"misses {ps.get('misses', 0)}")
        print("tau,loss,acc,eta,n_active,event")
        for h in sch.history:
            if h.event or not (h.loss != h.loss):   # event or evaluated
                print(f"{h.tau},{h.loss:.4f},{h.acc:.3f},{h.eta:.4f},"
                      f"{h.n_active},{h.event}")
        for k in ("rounds", "evals", "events_applied", "final_loss",
                  "final_acc", "mean_active", "clients_end", "capacity",
                  "wall_s", "rounds_per_sec"):
            print(f"{k},{summary[k]}")
    if args.json:
        payload = dict(summary)
        payload.pop("events", None)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        if not args.quiet:
            print(f"# wrote {args.json}")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
