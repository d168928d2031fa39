"""Serve a live federation: timed event traces against a FederationService.

Counterpart of ``repro/launch/fed_serve.py``, every flag of it plus
``--device`` (the CUDA device unless ``cpu``).  Unlike
``repro_torch.launch.fed_stream`` (which replays a scenario's events
through blocking ``run()`` calls), this CLI drives the *service* path: a
worker thread runs scheduler spans on the card continuously while the main
thread submits ParticipationEvents on a wall-clock schedule.

  PYTHONPATH=src python -m repro_torch.launch.fed_serve --scenario flash-crowd \\
      --rounds 40 --events-per-sec 20
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --scenario churn \\
      --dump-trace /tmp/churn.jsonl              # write the timed trace
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --trace /tmp/churn.jsonl
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --scenario churn \\
      --rounds 20 --snapshot /tmp/ckpt           # checkpoint at the end
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --resume /tmp/ckpt \\
      --rounds 20                                # ...and pick it back up
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --scenario churn \\
      --rounds 40 --chaos 7                      # supervised chaos soak

``--chaos SEED`` turns the run into a fault-injection soak: a seeded
FaultPlan (worker crashes and hangs, mid-span scheduler crashes,
checkpoint write failures and corruption, event floods, duplicated and
delayed ingestion) is wired into every boundary, and the service runs
supervised: periodic snapshots, a span watchdog, and crash-triggered
restore and replay.  The summary gains a ``"chaos"`` block (per-recovery
records, MTTR, fault log) from ``FederationService.chaos_report()``.  On
the card the round's kernels are built (``kernels.build``) before the
service starts, so that no worker generation's first span, and no
watchdog, waits on nvcc.

Trace format (JSONL), the reference's, so that a trace written by either
package replays in the other: one event per line, the ``fed/events.py``
dict schema with ndarray fields inlined as ``{"__ndarray__": {"data":
[...], "dtype": "float32"}}`` plus an optional ``"at"`` (seconds since
serve start) overriding the ``--events-per-sec`` pacing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the federated round's kernels (kernels/csrc): every span launches
# weighted_agg (or, on the int8 wires, weighted_agg_quant) and masked_sgd
ROUND_KERNELS = ("weighted_agg", "weighted_agg_quant", "masked_sgd")


def _to_jsonable(obj):
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": {"data": obj.tolist(),
                                "dtype": str(obj.dtype)}}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if set(obj) == {"__ndarray__"}:
            spec = obj["__ndarray__"]
            return np.asarray(spec["data"], dtype=np.dtype(spec["dtype"]))
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


def dump_trace(events, path: str, *, events_per_sec: float) -> None:
    """Write a timed JSONL trace: events in (tau, push order), submit
    times paced at ``events_per_sec``."""
    from repro_torch.fed.events import event_to_dict
    with open(path, "w") as f:
        for j, e in enumerate(sorted(events, key=lambda e: e.tau)):
            d = _to_jsonable(event_to_dict(e))
            d["at"] = round(j / events_per_sec, 4)
            f.write(json.dumps(d) + "\n")


def load_trace(path: str):
    """Read a JSONL trace: [(at_seconds, event), ...] in file order."""
    from repro_torch.fed.events import event_from_dict
    out = []
    with open(path) as f:
        for j, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = _from_jsonable(json.loads(line))
            at = float(d.pop("at", j * 0.01))
            out.append((at, event_from_dict(d)))
    return out


def build_round_kernels(device: torch.device) -> dict:
    """On the card, compile the round's kernels that have no up-to-date
    library (one nvcc each, started together); nothing on the CPU.
    Returns nvcc's report for each source compiled."""
    if device.type != "cuda":
        return {}
    from repro_torch.kernels import build
    return build.build(ROUND_KERNELS)


def main(argv=None) -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.fed.scenarios import (_paper_eval_fn, build_scheduler,
                                           make_scenario, summarize_history)
    from repro_torch.fed.service import FederationService
    from repro_torch.fed.stream import StreamScheduler

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", default="flash-crowd",
                    help="scenario generator for the fleet + event trace")
    ap.add_argument("--trace", default=None,
                    help="JSONL event trace to replay (overrides the "
                         "scenario's own events)")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="write the scenario's timed trace as JSONL "
                         "and exit")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume a saved checkpoint instead of building "
                         "a fresh scheduler")
    ap.add_argument("--snapshot", default=None, metavar="DIR",
                    help="write a resumable checkpoint when serving ends")
    ap.add_argument("--rounds", type=int, default=None,
                    help="serve until this round (default: scenario's)")
    ap.add_argument("--span-rounds", type=int, default=4,
                    help="rounds per worker span between ingest polls")
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--events-per-sec", type=float, default=50.0,
                    help="submission pacing for scenario traces")
    ap.add_argument("--max-pending", type=int, default=256,
                    help="inbox bound (backpressure threshold)")
    ap.add_argument("--mode", default=None, choices=["device", "plan"],
                    help="sampling mode (default: device; with --resume "
                         "the checkpoint's own mode unless given "
                         "explicitly — overriding it breaks exact resume)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="the reference's scan chunk; accepted, no effect")
    ap.add_argument("--compress", default=None,
                    choices=["none", "bf16", "int8", "int8-topk"],
                    help="client-delta wire format (default: none; with "
                         "--resume the checkpoint's own format unless "
                         "given explicitly)")
    ap.add_argument("--bank", action="store_true",
                    help="host-RAM client bank behind the slot registry "
                         "(fed/bank.py)")
    ap.add_argument("--prefetch", action="store_true",
                    help="stage the next arrival cohort on-device while "
                         "the current span runs (implies --bank)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run supervised with a seeded FaultPlan injected "
                         "at every boundary; adds a 'chaos' block to the "
                         "summary")
    ap.add_argument("--chaos-dir", default=None, metavar="DIR",
                    help="supervision snapshot directory for --chaos "
                         "(default: a fresh temp dir)")
    ap.add_argument("--snapshot-every", type=int, default=2,
                    help="spans between supervision auto-snapshots")
    ap.add_argument("--span-timeout", type=float, default=15.0,
                    help="watchdog: seconds of worker silence before the "
                         "supervisor declares a hang (--chaos only)")
    ap.add_argument("--max-restarts", type=int, default=8,
                    help="consecutive failed recoveries before giving up")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the CUDA device")
    ap.add_argument("--json", default=None,
                    help="also write the summary to this path")
    ap.add_argument("--top", action="store_true",
                    help="attach the fed_top live view while serving "
                         "(enables telemetry)")
    ap.add_argument("--top-interval", type=float, default=1.0,
                    help="fed_top refresh period in seconds")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the telemetry JSONL dump (spans + "
                         "metrics) here when serving ends (enables "
                         "telemetry)")
    ap.add_argument("--prom-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition here "
                         "when serving ends (enables telemetry)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    telemetry = None
    if args.top or args.metrics_out or args.prom_out:
        from repro_torch.obs import Telemetry
        telemetry = Telemetry()

    sc = make_scenario(args.scenario, seed=args.seed)
    if args.dump_trace:
        dump_trace(sc.events, args.dump_trace,
                   events_per_sec=args.events_per_sec)
        if not args.quiet:
            print(f"# wrote {len(sc.events)} events to {args.dump_trace}")
        return {"trace": args.dump_trace, "events": len(sc.events)}

    device = resolve_device(args.device)
    rounds = args.rounds if args.rounds is not None else sc.n_rounds
    eval_every = (args.eval_every if args.eval_every is not None
                  else sc.eval_every)

    if args.resume:
        # the checkpoint's own mode/wire unless given explicitly
        overrides = {} if args.mode is None else {"mode": args.mode}
        if args.compress is not None:
            overrides["compression"] = args.compress
        if args.bank:
            overrides["bank"] = True
        if args.prefetch:
            overrides["prefetch"] = True
        sch = StreamScheduler.restore(
            args.resume, loss_fn=_make_loss(), eval_fn=_paper_eval_fn(),
            model_kind=_model_kind(), device=device, telemetry=telemetry,
            **overrides)
        rounds = sch._next_tau + rounds   # serve this many MORE rounds
        timed = []
    elif args.trace:
        sch = build_scheduler(
            _strip_events(sc), mode=args.mode or "device",
            chunk_size=args.chunk_size, compression=args.compress,
            bank=args.bank or None, prefetch=args.prefetch,
            telemetry=telemetry, device=device)
        timed = load_trace(args.trace)
    else:
        sch = build_scheduler(
            _strip_events(sc), mode=args.mode or "device",
            chunk_size=args.chunk_size, compression=args.compress,
            bank=args.bank or None, prefetch=args.prefetch,
            telemetry=telemetry, device=device)
        timed = [(j / args.events_per_sec, e) for j, e in
                 enumerate(sorted(sc.events, key=lambda e: e.tau))]
    start_tau = sch._next_tau             # 0 fresh; checkpoint tau resumed

    svc_kwargs: dict = {}
    if args.chaos is not None:
        import tempfile

        from repro_torch.fed.faults import FaultPlan
        n_spans = max(1, rounds // max(1, args.span_rounds))
        sch.injector = FaultPlan.generate(
            args.chaos, spans=n_spans,
            saves=max(1, n_spans // args.snapshot_every))
        snap_dir = args.chaos_dir or tempfile.mkdtemp(prefix="fed-chaos-")
        engine = sch.engine               # survives scheduler rebuilds
        svc_kwargs = dict(
            supervise=True, snapshot_dir=snap_dir,
            snapshot_every=args.snapshot_every,
            span_timeout=args.span_timeout,
            max_restarts=args.max_restarts,
            queue_policy="merge-stale",
            engine_factory=lambda: engine,
            restore_kwargs=dict(loss_fn=_make_loss(),
                                eval_fn=_paper_eval_fn(),
                                model_kind=_model_kind(), device=device))

    built = build_round_kernels(device)
    svc = FederationService(sch, span_rounds=args.span_rounds,
                            eval_every=eval_every, max_rounds=rounds,
                            max_pending=args.max_pending, **svc_kwargs)
    top_stop = None
    t0 = time.perf_counter()
    with svc:
        if args.top:
            from repro_torch.launch.fed_top import attach
            _, top_stop = attach(svc, interval=args.top_interval)
        for at, e in timed:               # the main thread is the client
            delay = at - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            svc.submit(e)
        svc.drain()
        svc.wait_rounds(rounds, timeout=600)
        if args.snapshot:
            svc.snapshot(args.snapshot)
        if top_stop is not None:
            top_stop.set()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    sch = svc.scheduler                   # recovery may have rebuilt it
    served = sch._next_tau - start_tau    # this invocation's rounds only
    summary = summarize_history(sch.history)
    summary.update(scenario=sc.name, wall_s=round(wall, 3),
                   compression=sch.engine.compression.name,
                   rounds_served=served,
                   rounds_per_sec=round(served / wall, 2),
                   **{k: v for k, v in svc.stats().items()
                      if k not in ("running", "paused")})
    if args.chaos is not None:
        summary["chaos"] = svc.chaos_report()
    if telemetry is not None:
        if args.metrics_out:
            telemetry.dump_jsonl(args.metrics_out)
        if args.prom_out:
            telemetry.write_prom(args.prom_out)
        summary["telemetry"] = {
            "spans_recorded": telemetry.tracer.recorded,
            "spans_dropped": telemetry.tracer.dropped,
            "metrics_out": args.metrics_out,
            "prom_out": args.prom_out}
    if not args.quiet:
        where = (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")
        print(f"# device {where}"
              + (f", built {', '.join(built)}" if built else ""))
        print(f"# served {served} rounds in {wall:.2f}s "
              f"({summary['rounds_per_sec']} rounds/s), "
              f"{svc.events_ingested} events ingested live")
        if args.chaos is not None:
            ch = summary["chaos"]
            print(f"# chaos: {ch['n_recoveries']} recoveries, "
                  f"mttr_mean={ch['mttr_mean_s']:.3f}s, "
                  f"{ch['recovered_rounds']} rounds recomputed, "
                  f"{len(ch.get('faults', {}).get('fired', []))} faults "
                  f"fired")
        for k in ("evals", "final_loss", "final_acc", "mean_active",
                  "events_submitted", "events_applied", "spans_run"):
            print(f"{k},{summary[k]}")
        if args.snapshot:
            print(f"# checkpoint written to {args.snapshot}")
    if args.json:
        payload = {k: v for k, v in summary.items() if k != "events"}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
    return summary


def _make_loss():
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.models.small import make_loss_fn
    return make_loss_fn(SYNTHETIC_LR)


def _model_kind() -> str:
    from repro_torch.configs.paper import SYNTHETIC_LR
    return SYNTHETIC_LR.kind


def _strip_events(sc):
    """The service submits the trace live — the scheduler must not also
    preload the scenario's events."""
    import dataclasses
    return dataclasses.replace(sc, events=[])


if __name__ == "__main__":
    main(sys.argv[1:])
