"""``top`` for a live federation: plain-refresh terminal view of a
FederationService.

Counterpart of ``repro/launch/fed_top.py``, frame for frame.

Renders one full frame per tick from the service's telemetry registry
and ``stats()``/``chaos_report()`` views — rounds/sec, inbox depth and
ingest lag, worker heartbeat age, busy/idle/overhead attribution, the
paper's participation gauges (active/inactive devices, scheme weight
mass and drift, per-client participation rates, live Theorem 3.1 bound
terms when attached), and the recovery history.  Rendering is stdlib
only and side-effect free: ``FedTop.frame()`` returns the frame as a
string, so tests (and ``--once``) can render headlessly.

Standalone (drives a scenario through the service, view attached):

  PYTHONPATH=src python -m repro_torch.launch.fed_top --scenario flash-crowd \
      --rounds 40
  PYTHONPATH=src python -m repro_torch.launch.fed_top --scenario churn \
      --chaos 7 --top-interval 0.5 --device cpu

This is exactly ``repro_torch.launch.fed_serve`` with ``--top`` injected —
every fed_serve flag works here (``--device cpu`` included).
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Optional


def _val(snap: dict, name: str, labels: Optional[dict] = None,
         default: float = 0.0) -> float:
    """One counter/gauge sample out of a MetricsRegistry.snapshot()."""
    fam = snap.get(name)
    if not fam:
        return default
    want = labels or {}
    for s in fam["samples"]:
        if all(s["labels"].get(k) == str(v) for k, v in want.items()):
            return s.get("value", default)
    return default


def _hist(snap: dict, name: str, labels: Optional[dict] = None):
    """(count, sum, mean) of a histogram sample, or (0, 0.0, None)."""
    fam = snap.get(name)
    want = labels or {}
    if fam:
        for s in fam["samples"]:
            if all(s["labels"].get(k) == str(v)
                   for k, v in want.items()):
                n, tot = s.get("count", 0), s.get("sum", 0.0)
                return n, tot, (tot / n if n else None)
    return 0, 0.0, None


def _fmt_b(v: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if v < 1024 or unit == "GiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}GiB"


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


class FedTop:
    """Frame renderer + refresh loop over one FederationService."""

    def __init__(self, svc, width: int = 78):
        self.svc = svc
        self.width = width
        self._prev: Optional[tuple] = None     # (monotonic, rounds)

    # -- one frame -------------------------------------------------------------
    def frame(self) -> str:
        svc = self.svc
        now = time.monotonic()
        st = svc.stats()
        tel = svc.telemetry
        snap = (tel.registry.snapshot() if tel.enabled
                else svc._registry.snapshot())
        rounds = int(st["rounds"])
        rate = None
        if self._prev is not None:
            t0, r0 = self._prev
            if now > t0:
                rate = (rounds - r0) / (now - t0)
        self._prev = (now, rounds)

        eng = getattr(getattr(svc, "scheduler", None), "engine", None)
        wire = (eng.compression.name if eng is not None
                and hasattr(eng, "compression") else "?")

        W = self.width
        bar = "-" * W
        lines = [
            f"fed_top  gen={st['generation']}  "
            f"{'supervised' if st['supervised'] else 'unsupervised'}  "
            f"{'PAUSED' if st['paused'] else 'running' if st['running'] else 'stopped'}"
            f"  wire={wire}"
            .ljust(W),
            bar,
            f"rounds     tau={rounds}"
            + (f"  {rate:.1f} r/s" if rate is not None else "")
            + f"  spans={st['spans_run']}"
            f"  heartbeat {_fmt_s(_val(snap, 'svc_heartbeat_age_s'))} ago",
            f"events     submitted={st['events_submitted']} "
            f"ingested={st['events_ingested']} "
            f"applied={st['events_applied']} "
            f"pending={st['events_pending']} inbox={st['inbox_depth']}",
            f"           merged={st['events_merged']} "
            f"dup={st['events_duplicated']} "
            f"delayed={st['events_delayed']} "
            f"flooded={st['events_flooded']}",
        ]

        busy = _val(snap, "svc_busy_seconds_total")
        idle = _val(snap, "svc_idle_seconds_total")
        over = _val(snap, "svc_overhead_seconds_total")
        total = busy + idle + over
        n_lag, _, lag_mean = _hist(snap, "svc_ingest_lag_seconds")
        lines.append(
            f"service    busy={busy:.2f}s idle={idle:.2f}s "
            f"overhead={over:.3f}s"
            + (f"  (overhead {over / total:.1%})" if total > 0 else "")
            + f"  ingest lag {_fmt_s(lag_mean)} (n={n_lag})")

        if tel.enabled:
            active = _val(snap, "fed_active_clients")
            n_obj = _val(snap, "fed_objective_clients")
            lines.append(
                f"paper      active={active:.0f}/{n_obj:.0f} devices  "
                f"mass={_val(snap, 'fed_scheme_weight_mass'):.4f} "
                f"drift={_val(snap, 'fed_scheme_weight_drift'):+.4f}  "
                f"eta={_val(snap, 'fed_eta'):.4g}")
            rate_min = _val(snap, "fed_participation_rate",
                            {"stat": "min"})
            rate_mean = _val(snap, "fed_participation_rate",
                             {"stat": "mean"})
            rate_max = _val(snap, "fed_participation_rate",
                            {"stat": "max"})
            n_st, _, st_mean = _hist(snap, "fed_event_staleness_rounds")
            lines.append(
                f"           participation min/mean/max = "
                f"{rate_min:.2f}/{rate_mean:.2f}/{rate_max:.2f}  "
                f"staleness mean="
                + (f"{st_mean:.1f} rounds" if st_mean is not None
                   else "-")
                + f" (n={n_st})")
            if snap.get("fed_bound", {}).get("samples"):
                lines.append(
                    f"bound      D={_val(snap, 'fed_bound', {'term': 'D'}):.4g} "
                    f"V={_val(snap, 'fed_bound', {'term': 'V'}):.4g} "
                    f"gamma={_val(snap, 'fed_bound', {'term': 'gamma'}):.4g} "
                    f"value={_val(snap, 'fed_bound', {'term': 'value'}):.4g}")

        fam = snap.get("fed_wire_bytes_total")
        if fam and fam["samples"]:
            per_wire = ", ".join(
                f"{s['labels'].get('wire', '?')}={_fmt_b(s['value'])}"
                for s in fam["samples"])
            lines.append(f"wire       uplink {per_wire}")
        hits = _val(snap, "sched_prefetch_hits_total")
        misses = _val(snap, "sched_prefetch_misses_total")
        if hits or misses:
            lines.append(
                f"prefetch   hits={hits:.0f} misses={misses:.0f}  "
                f"({hits / (hits + misses):.0%} staged ahead)")

        recs = list(svc.recoveries)
        if st["supervised"] or recs:
            n_rec, _, mttr_mean = _hist(snap, "svc_recovery_seconds")
            lines.append(
                f"recovery   {len(recs)} total  "
                f"mttr mean={_fmt_s(mttr_mean)}  "
                f"snapshot failures={st['snapshot_failures']}  "
                f"snapshots kept={st['snapshots_kept']}")
            for r in recs[-3:]:
                cause = r["cause"]
                if len(cause) > 40:
                    cause = cause[:37] + "..."
                lines.append(
                    f"  g{r['generation']} {cause}  "
                    f"mttr={_fmt_s(r['mttr_s'])} "
                    f"detect={_fmt_s(r.get('detect_latency_s', 0.0))} "
                    f"replayed={r['events_replayed']}")

        fam = snap.get("faults_fired_total")
        if fam and fam["samples"]:
            fired = ", ".join(
                f"{s['labels'].get('site', '?')}/"
                f"{s['labels'].get('kind', '?')}x{s['value']:.0f}"
                for s in fam["samples"])
            lines.append(f"faults     {fired}")
        lines.append(bar)
        return "\n".join(ln[:W] for ln in lines) + "\n"

    # -- refresh loop ----------------------------------------------------------
    def run(self, interval: float = 1.0,
            stop: Optional[threading.Event] = None,
            out=None, max_frames: Optional[int] = None) -> int:
        """Plain-refresh loop: clear + redraw each tick until ``stop`` is
        set (or ``max_frames`` frames).  Returns frames drawn."""
        out = out if out is not None else sys.stdout
        clear = "\x1b[2J\x1b[H" if getattr(out, "isatty",
                                           lambda: False)() else ""
        n = 0
        while max_frames is None or n < max_frames:
            out.write(clear + self.frame())
            out.flush()
            n += 1
            if stop is not None and stop.wait(interval):
                break
            if stop is None and max_frames is None:
                time.sleep(interval)
        return n


def attach(svc, interval: float = 1.0, out=None):
    """Start a daemon display thread over a running service; returns
    (thread, stop_event) — set the event to detach."""
    top = FedTop(svc)
    stop = threading.Event()
    t = threading.Thread(target=top.run,
                         kwargs=dict(interval=interval, stop=stop,
                                     out=out),
                         name="fed-top", daemon=True)
    t.start()
    return t, stop


def main(argv=None) -> dict:
    from repro_torch.launch import fed_serve
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--top" not in argv:
        argv.append("--top")
    return fed_serve.main(argv)


if __name__ == "__main__":
    main()
