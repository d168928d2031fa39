"""Deterministic fault injection for the federation service stack.

Counterpart of ``repro/fed/faults.py``, numpy and the standard library
only: a seed names the same plan in both packages (``generate`` draws in
the reference's order), and ``corrupt_file`` and ``make_flood`` take the
same draws from the plan's generator, so both packages inject the same
chaos into the same workload.

The paper's premise is that *devices* fail arbitrarily; this module makes
the *service* fail arbitrarily too — on a seed-reproducible schedule — so
the supervision layer (``fed/service.py``) can be tested against the same
chaos the algorithm tolerates from clients.

A ``FaultPlan`` is a list of ``Fault`` entries, each bound to an
*injection site* and a 0-based call index at that site.  The hook points
threaded through the stack call ``plan.fire(site, ...)``; the plan either
does nothing (no fault scheduled for that call) or injects the scheduled
failure:

  site ``worker``       — top of each FederationService worker span:
                          ``crash`` raises InjectedFault, ``hang`` stalls
                          the worker (watchdog-visible) until the span
                          timeout or service abort releases it;
  site ``sched_span``   — each span iteration inside StreamScheduler.run:
                          ``crash`` raises *mid-run*, leaving the
                          scheduler torn (history appended, next_tau
                          stale) — the supervisor must discard it;
  site ``ckpt_save``    — inside save_fed_checkpoint, after the payload
                          was staged but before the atomic rename:
                          ``io-error`` raises InjectedWriteError (the
                          canonical checkpoint is never touched);
  site ``ckpt_written`` — after a checkpoint landed on disk: ``corrupt``
                          flips bytes in the npz (silent bitrot, detected
                          by the load-time checksum);
  site ``flood``        — top of each worker span: ``flood`` returns the
                          Fault so the service can push ``size`` stale
                          no-op TraceShifts (ingestion outrunning span
                          boundaries — the event-heap overflow scenario);
  site ``ingest``       — per event moved from the inbox to the
                          scheduler: ``dup`` delivers the event twice,
                          ``delay`` holds it back one ingest cycle
                          (out-of-order delivery).

Every random choice (corruption offsets, flood targets) comes from the
plan's own seeded generator, and fault firing is keyed by deterministic
per-site call counters — rerunning the same workload with the same plan
injects byte-identical chaos, which is what makes chaos failures
replayable (``fed_serve --chaos <seed>``).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A deliberately injected crash (FaultPlan kind='crash')."""


class InjectedWriteError(OSError):
    """A deliberately injected checkpoint write failure."""


_KINDS_BY_SITE = {
    "worker": ("crash", "hang"),
    "sched_span": ("crash",),
    "ckpt_save": ("io-error",),
    "ckpt_written": ("corrupt",),
    "flood": ("flood",),
    "ingest": ("dup", "delay"),
}


@dataclass(frozen=True)
class Fault:
    """One scheduled failure: fire ``kind`` on the ``at``-th call (0-based)
    to injection site ``site``.  ``size`` scales flood events / corrupted
    bytes; ``seconds`` is the hang duration."""
    site: str
    at: int
    kind: str
    size: int = 0
    seconds: float = 0.0

    def __post_init__(self):
        if self.site not in _KINDS_BY_SITE:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"known: {sorted(_KINDS_BY_SITE)}")
        if self.kind not in _KINDS_BY_SITE[self.site]:
            raise ValueError(f"kind {self.kind!r} invalid at site "
                             f"{self.site!r} (allowed: "
                             f"{_KINDS_BY_SITE[self.site]})")


@dataclass
class FaultPlan:
    """A deterministic, seed-reproducible schedule of injected failures.

    Thread-safe: per-site call counters are guarded by one lock (hook
    sites run on the service worker thread, corruption helpers may be
    reached from control threads).
    """
    faults: List[Fault] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self._by_site: Dict[Tuple[str, int], Fault] = {}
        for f in self.faults:
            key = (f.site, f.at)
            if key in self._by_site:
                raise ValueError(f"duplicate fault at {key}")
            self._by_site[key] = f
        self._counts: Dict[str, int] = {}
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []
        from repro_torch.obs.telemetry import NULL
        self._m_fired = NULL.counter("faults_fired_total")

    def attach_telemetry(self, telemetry) -> None:
        """Count fired faults on a live registry
        (``faults_fired_total{site,kind}``); null-safe."""
        from repro_torch.obs.telemetry import resolve
        self._m_fired = resolve(telemetry).counter(
            "faults_fired_total", "injected faults fired, by site and "
            "kind", labelnames=("site", "kind"))

    @classmethod
    def generate(cls, seed: int, *, spans: int = 12, saves: int = 6,
                 hang_seconds: float = 30.0,
                 flood_size: int = 256, hang: bool = True) -> "FaultPlan":
        """A reproducible mixed chaos plan: one worker crash, one mid-span
        crash, one hang, one write failure, one corruption and one flood,
        placed at seeded positions — the ``fed_serve --chaos <seed>``
        profile.

        ``hang=False`` omits the worker hang (recovering a hang costs a
        span-timeout of watchdog latency — the fuzzed-chaos tier-1
        corpus trades that fault for wall-clock).  The rng draw order is
        unchanged, so a seed names the same plan either way."""
        rng = np.random.default_rng(seed)
        worker_slots = rng.choice(max(spans, 4), size=3, replace=False)
        faults = [
            Fault("worker", int(worker_slots[0]), "crash"),
            Fault("worker", int(worker_slots[1]), "hang",
                  seconds=hang_seconds),
            Fault("sched_span", int(worker_slots[2]), "crash"),
            Fault("ckpt_save", int(rng.integers(0, max(saves, 1))),
                  "io-error"),
            Fault("ckpt_written", int(rng.integers(0, max(saves, 1))),
                  "corrupt", size=16),
            Fault("flood", int(rng.integers(0, max(spans, 1))), "flood",
                  size=flood_size),
        ]
        if not hang:
            faults = [f for f in faults if f.kind != "hang"]
        return cls(faults=faults, seed=seed)

    # -- firing ---------------------------------------------------------------
    def _take(self, site: str) -> Optional[Fault]:
        with self._lock:
            k = self._counts.get(site, 0)
            self._counts[site] = k + 1
            f = self._by_site.get((site, k))
            if f is not None:
                self.fired.append((site, k, f.kind))
                self._m_fired.labels(site, f.kind).inc()
            return f

    def fire(self, site: str, *, abort: Optional[threading.Event] = None,
             path: Optional[str] = None, **ctx) -> Optional[Fault]:
        """Consult the plan at an injection site.  Raises for crash/write
        faults, stalls for hangs, corrupts ``path`` for bitrot faults, and
        returns the Fault for caller-interpreted kinds (flood/dup/delay).
        Returns None when nothing is scheduled for this call."""
        f = self._take(site)
        if f is None:
            return None
        if f.kind == "crash":
            raise InjectedFault(f"injected crash at {site}#{f.at}")
        if f.kind == "io-error":
            raise InjectedWriteError(
                f"injected checkpoint write failure at {site}#{f.at}")
        if f.kind == "hang":
            # watchdog-visible stall: wait on the service's abort event so
            # a recovered (or stopping) service releases the stuck worker
            # instead of leaking a sleeping thread
            (abort if abort is not None else threading.Event()).wait(
                f.seconds)
            return f
        if f.kind == "corrupt":
            if path is not None:
                corrupt_file(path, self._rng, nbytes=f.size or 16)
            return f
        return f                            # flood / dup / delay

    def summary(self) -> dict:
        return {"seed": self.seed,
                "scheduled": len(self.faults),
                "fired": [list(t) for t in self.fired]}


def corrupt_file(path: str, rng: np.random.Generator,
                 nbytes: int = 16) -> None:
    """Flip ``nbytes`` bytes at seeded offsets of an on-disk file —
    silent bitrot that only a content checksum can catch."""
    import os
    size = os.path.getsize(path)
    if size == 0:
        return
    offsets = rng.integers(0, size, size=max(1, nbytes))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF if b else 0xFF]))
        f.flush()
        os.fsync(f.fileno())


def make_flood(state, size: int, rng: np.random.Generator) -> list:
    """``size`` stale no-op TraceShifts over the currently slotted
    objective members, each restating the client's *current* trace —
    the heap-growth traffic pattern the merge-stale queue policy exists
    to absorb (a retrying edge re-announcing known availability laws)."""
    from repro_torch.fed.events import TraceShift
    targets = sorted(i for i in state.slot_of if i in state.objective)
    if not targets:
        return []
    picks = rng.integers(0, len(targets), size=size)
    return [TraceShift(0, client_id=targets[int(j)],
                       trace=state.clients[targets[int(j)]].trace)
            for j in picks]
