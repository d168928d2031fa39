"""Scenario library: reproducible participation-event streams.

Counterpart of ``repro/fed/scenarios.py``.  Each generator composes
ParticipationEvents into a named workload and is a pure function of its
seed: the same (name, seed, size knobs) always yields the same client
fleet and event stream, array for array the reference's (the port's
``data.synthetic_federation`` and ``TRACES`` are copies of the
reference's, drawn from the same numpy generators).

  diurnal      availability waves: the fleet splits into two "timezones"
               whose traces swing between high- and low-availability laws
               every half period (TraceShift waves).
  flash-crowd  a burst of brand-new devices arrives over a few rounds,
               trains for a while, then churns out (Arrivals + Departures
               through capacity slots).
  staggered    staggered-cohort rollout: cohort k of brand-new devices
               arrives at k * spacing (a product launch ramp).
  churn        correlated churn: recurring InactivityBursts over random
               cohorts plus one auto-policy departure and a replacement
               arrival.
  rotation     a fleet larger than the capacity rotates through its slots
               (including departures, client_id rejoins).

``run_scenario`` builds a StreamScheduler on the paper's SYNTHETIC logreg
workload, starting from the reference's initial parameters for the
scenario's seed (``scenario_init.npz``, written by
``tools/scenario_reference.py``), replays the stream end to end and
returns an honest summary: rounds without an eval record NaN loss/acc,
and ``summarize_history`` filters them.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.participation import TRACES
from repro_torch.fed.driver import Client, RoundRecord
from repro_torch.fed.events import (Arrival, Departure, InactivityBurst,
                                    ParticipationEvent, TraceShift)

# the reference's init_small(PRNGKey(seed), SYNTHETIC_LR) for the committed
# seeds, keys "seed<s>/<leaf>" (tools/scenario_reference.py)
INIT_FILE = Path(__file__).with_name("scenario_init.npz")

# high-availability (charger+wifi) vs low-availability (contended) laws
# used by the diurnal wave; indices into the Table-2 reconstruction
_DAY_TRACE = TRACES[1]      # cpu_30: mean 0.90
_NIGHT_TRACE = TRACES[6]    # bw_med: mean 0.65, 20% inactive


@dataclass
class Scenario:
    """A named, fully reproducible streaming-participation workload."""
    name: str
    clients: List[Client]                    # founding fleet (slots 0..C-1)
    events: List[ParticipationEvent]
    capacity: int
    n_rounds: int
    eval_every: int = 5
    local_epochs: int = 5
    batch_size: int = 10
    scheme: str = "C"
    eta0: float = 1.0
    seed: int = 0
    max_samples: Optional[int] = None
    notes: str = ""

    def signature(self) -> list:
        """Structural fingerprint used by reproducibility tests: event
        types/taus/targets without array payloads."""
        sig = []
        for e in self.events:
            if isinstance(e, Arrival):
                sig.append(("arrival", e.tau,
                            e.client.n if e.client is not None
                            else e.client_id))
            elif isinstance(e, Departure):
                sig.append(("departure", e.tau, e.client_id, e.policy))
            elif isinstance(e, TraceShift):
                sig.append(("trace-shift", e.tau, e.client_id,
                            e.trace.name))
            elif isinstance(e, InactivityBurst):
                sig.append(("burst", e.tau, e.duration, e.client_ids))
        return sig


def _make_clients(n: int, seed: int, trace_pool=range(8),
                  alpha: float = 0.5, beta: float = 0.5) -> List[Client]:
    from repro_torch.data import synthetic_federation
    train, test = synthetic_federation(alpha, beta, n, seed=seed)
    rng = np.random.default_rng(seed)
    pool = list(trace_pool)
    return [Client(x=tr[0], y=tr[1],
                   trace=TRACES[pool[rng.integers(0, len(pool))]],
                   x_test=te[0], y_test=te[1])
            for tr, te in zip(train, test)]


# -- generators ---------------------------------------------------------------

def diurnal(*, n_clients: int = 8, n_rounds: int = 32, period: int = 8,
            seed: int = 0) -> Scenario:
    """Two timezones in anti-phase: every half period, one half of the
    fleet shifts to the day law and the other to the night law."""
    clients = _make_clients(n_clients, seed, trace_pool=[1])
    half = max(1, period // 2)
    zone_a = list(range(0, n_clients, 2))
    zone_b = list(range(1, n_clients, 2))
    events: List[ParticipationEvent] = []
    for k, tau in enumerate(range(half, n_rounds, half)):
        day, night = (zone_a, zone_b) if k % 2 == 0 else (zone_b, zone_a)
        for i in night:
            events.append(TraceShift(tau, i, _NIGHT_TRACE))
        for i in day:
            events.append(TraceShift(tau, i, _DAY_TRACE))
    return Scenario("diurnal", clients, events, capacity=n_clients,
                    n_rounds=n_rounds, seed=seed,
                    notes=f"{n_clients} clients, period {period}")


def flash_crowd(*, n_founding: int = 6, n_crowd: int = 6,
                arrive_at: int = 6, stay: int = 10, n_rounds: int = 28,
                seed: int = 0) -> Scenario:
    """A crowd of brand-new devices floods in over three rounds, trains
    for ``stay`` rounds, then churns out (exclude policy)."""
    clients = _make_clients(n_founding, seed)
    crowd = _make_clients(n_crowd, seed + 1000)
    nmax = max(c.n for c in clients + crowd)
    events: List[ParticipationEvent] = []
    taus_in = [arrive_at + j % 3 for j in range(n_crowd)]  # 3-round stagger
    # ids are assigned when the Arrival is applied, in (tau, push order)
    # sequence: compute each crowd member's id accordingly
    order = sorted(range(n_crowd), key=lambda j: (taus_in[j], j))
    id_of = {j: n_founding + r for r, j in enumerate(order)}
    for j, cl in enumerate(crowd):
        events.append(Arrival(taus_in[j], client=cl))
        events.append(Departure(taus_in[j] + stay, client_id=id_of[j],
                                policy="exclude"))
    return Scenario("flash-crowd", clients, events,
                    capacity=n_founding + n_crowd, n_rounds=n_rounds,
                    seed=seed, max_samples=nmax,
                    notes=f"{n_founding}+{n_crowd} clients, "
                          f"crowd at tau={arrive_at}")


def staggered_rollout(*, n_cohorts: int = 3, cohort_size: int = 3,
                      spacing: int = 6, n_rounds: int = 26,
                      seed: int = 0) -> Scenario:
    """Cohort 0 is founding; cohort k of brand-new devices arrives at
    k * spacing (a staged product rollout)."""
    clients = _make_clients(cohort_size, seed)
    events: List[ParticipationEvent] = []
    nmax = max(c.n for c in clients)
    for k in range(1, n_cohorts):
        cohort = _make_clients(cohort_size, seed + 1000 * k)
        nmax = max(nmax, max(c.n for c in cohort))
        for cl in cohort:
            events.append(Arrival(k * spacing, client=cl))
    return Scenario("staggered", clients, events,
                    capacity=n_cohorts * cohort_size, n_rounds=n_rounds,
                    seed=seed, max_samples=nmax,
                    notes=f"{n_cohorts} cohorts x {cohort_size}, "
                          f"spacing {spacing}")


def correlated_churn(*, n_clients: int = 10, n_rounds: int = 30,
                     burst_every: int = 7, burst_frac: float = 0.4,
                     burst_len: int = 3, seed: int = 0) -> Scenario:
    """Recurring correlated outages (InactivityBursts over random cohorts)
    plus one auto-policy departure and one replacement arrival."""
    clients = _make_clients(n_clients, seed)
    rng = np.random.default_rng(seed + 7)
    events: List[ParticipationEvent] = []
    k = max(1, int(round(burst_frac * n_clients)))
    for tau in range(burst_every, n_rounds, burst_every):
        cohort = tuple(sorted(rng.choice(n_clients, size=k,
                                         replace=False).tolist()))
        events.append(InactivityBurst(tau, burst_len, cohort))
    # one device departs mid-run under the Corollary-4.0.3 auto policy...
    leaver = int(rng.integers(0, n_clients))
    events.append(Departure(n_rounds // 2, client_id=leaver,
                            policy="auto"))
    # ...and a replacement (brand-new data) arrives shortly after, reusing
    # the freed capacity slot when the departure excluded
    repl = _make_clients(1, seed + 2000)[0]
    events.append(Arrival(n_rounds // 2 + 2, client=repl))
    nmax = max(max(c.n for c in clients), repl.n)
    return Scenario("churn", clients, events, capacity=n_clients + 1,
                    n_rounds=n_rounds, seed=seed, max_samples=nmax,
                    notes=f"{n_clients} clients, burst every "
                          f"{burst_every} for {burst_len}")


def rotation_events(fleet_clients: Sequence[Client], hot: int, dwell: int,
                    n_rounds: int) -> List[ParticipationEvent]:
    """The rotation schedule over ``fleet_clients``, of which the first
    ``hot`` are resident at tau 0: every ``dwell`` rounds the oldest
    resident departs (include policy) and the next fleet member arrives,
    a brand-new payload until every client has been seen, then a
    client_id rejoin of the longest departed."""
    events: List[ParticipationEvent] = []
    resident = deque(range(hot))
    departed_q: deque = deque()
    # first-time arrivals get ids in application order: hot, hot+1, ...
    next_new = hot
    for tau in range(dwell, n_rounds, dwell):
        old = resident.popleft()
        events.append(Departure(tau, client_id=old, policy="include"))
        departed_q.append(old)
        if next_new < len(fleet_clients):
            events.append(Arrival(tau, client=fleet_clients[next_new]))
            resident.append(next_new)
            next_new += 1
        else:
            back = departed_q.popleft()
            events.append(Arrival(tau, client_id=back))
            resident.append(back)
    return events


def rotation(*, fleet: int = 40, hot: int = 12, dwell: int = 2,
             n_rounds: int = 60, seed: int = 0) -> Scenario:
    """A fleet far larger than the hot-slot capacity rotates through the
    engine (``rotation_events``): every ``dwell`` rounds the oldest
    resident departs (include policy: its data mass stays in the
    objective) and the next fleet member arrives, first as a brand-new
    payload, then as a client_id rejoin once everyone has been seen.  At
    most ``hot`` clients are resident at any time, so the scenario runs on
    ``hot`` capacity slots; slot allocation is lowest-free-first, so a run
    with capacity >= fleet assigns the same slots."""
    all_clients = _make_clients(fleet, seed)
    events = rotation_events(all_clients, hot, dwell, n_rounds)
    nmax = max(c.n for c in all_clients)
    return Scenario("rotation", all_clients[:hot], events, capacity=hot,
                    n_rounds=n_rounds, seed=seed, max_samples=nmax,
                    notes=f"fleet {fleet} through {hot} hot slots, "
                          f"dwell {dwell}")


SCENARIOS: Dict[str, Callable[..., Scenario]] = {
    "diurnal": diurnal,
    "flash-crowd": flash_crowd,
    "staggered": staggered_rollout,
    "churn": correlated_churn,
    "rotation": rotation,
}


def make_scenario(name: str, *, seed: int = 0, **kwargs) -> Scenario:
    key = name.replace("_", "-")
    if key not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"known: {sorted(SCENARIOS)}")
    return SCENARIOS[key](seed=seed, **kwargs)


# -- execution + honest summaries ---------------------------------------------

def committed_seeds() -> List[int]:
    """The seeds whose initial parameters ``scenario_init.npz`` holds."""
    with np.load(INIT_FILE) as f:
        return sorted({int(k.split("/")[0][len("seed"):]) for k in f.files
                       if k.startswith("seed")})


def scenario_init(seed: int, device=None):
    """The reference's ``init_small(PRNGKey(seed), SYNTHETIC_LR)`` as the
    port's parameters on ``device``.  Raises ValueError for a seed the
    committed file does not hold: the port's own draw would start another
    run under the same name."""
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.params import from_jax
    prefix = f"seed{int(seed)}/"
    with np.load(INIT_FILE) as f:
        arrays = {k[len(prefix):]: f[k] for k in f.files
                  if k.startswith(prefix)}
    if not arrays:
        raise ValueError(
            f"no initial parameters for seed {seed} in {INIT_FILE.name} "
            f"(seeds {committed_seeds()}); add it with "
            f"tools/scenario_reference.py")
    return from_jax(arrays, SYNTHETIC_LR, device)


def build_scheduler(sc: Scenario, *, mode: str = "device",
                    chunk_size: int = 16, agg: str = "auto",
                    interpret=None, compression=None,
                    with_metrics: bool = False, telemetry=None,
                    engine_mode: str = "client_parallel",
                    capacity: Optional[int] = None,
                    bank=None, prefetch: bool = False, device=None):
    """StreamScheduler for a scenario on the paper's SYNTHETIC logreg, on
    ``device`` (the CUDA device unless ``"cpu"``), from the reference's
    initial parameters for ``sc.seed`` (``scenario_init``).
    ``capacity=`` overrides the scenario's slot count (fleet-beyond-
    capacity runs keep the overflow in the bank); ``bank=``/``prefetch=``
    enable the tiered client store and the cohort prefetch
    (``fed/bank.py``); ``telemetry=`` instruments scheduler, engine and
    checkpoints (``repro_torch.obs``); ``interpret=`` is refused unless
    null, as the scheduler refuses it (``stream.refuse_unported``)."""
    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.device import resolve_device
    from repro_torch.fed.stream import StreamScheduler
    from repro_torch.models.small import make_loss_fn

    device = resolve_device(device)
    return StreamScheduler(
        clients=sc.clients, init_params=scenario_init(sc.seed, device),
        loss_fn=make_loss_fn(SYNTHETIC_LR), eval_fn=_paper_eval_fn(),
        capacity=capacity if capacity is not None else sc.capacity,
        max_samples=sc.max_samples,
        local_epochs=sc.local_epochs, batch_size=sc.batch_size,
        scheme=sc.scheme, eta0=sc.eta0, chunk_size=chunk_size, agg=agg,
        interpret=interpret, compression=compression,
        with_metrics=with_metrics, seed=sc.seed, mode=mode,
        events=sc.events, telemetry=telemetry, engine_mode=engine_mode,
        bank=bank, prefetch=prefetch, device=device,
        model_kind=SYNTHETIC_LR.kind)


def _paper_eval_fn():
    """eval_fn(params, x, y) -> (loss, acc) as floats: the mean
    cross-entropy of the logreg's log-softmax and its accuracy."""
    import torch

    from repro_torch.configs.paper import SYNTHETIC_LR
    from repro_torch.models.small import accuracy_of, logits_small

    def eval_fn(params, x, y):
        lg = logits_small(params, SYNTHETIC_LR, x)
        ll = torch.log_softmax(lg, -1)
        loss = -ll.gather(1, y[:, None].long()).mean()
        return float(loss), float(accuracy_of(lg, y))

    return eval_fn


def summarize_history(history: Sequence[RoundRecord]) -> dict:
    """History consumers must filter NaN rounds (RoundRecord.loss/acc are
    NaN whenever no eval ran)."""
    evald = [h for h in history if np.isfinite(h.loss)]
    return {
        "rounds": len(history),
        "evals": len(evald),
        "final_loss": float(evald[-1].loss) if evald else None,
        "final_acc": float(evald[-1].acc) if evald else None,
        "best_acc": max((float(h.acc) for h in evald), default=None),
        "mean_active": (float(np.mean([h.n_active for h in history]))
                        if history else 0.0),
        "events": [(h.tau, h.event) for h in history if h.event],
    }


def run_scenario(sc: Scenario, *, mode: str = "device",
                 eval_every: Optional[int] = None,
                 n_rounds: Optional[int] = None, **kw):
    """Replay a scenario end to end; returns (scheduler, summary)."""
    sch = build_scheduler(sc, mode=mode, **kw)
    sch.run(n_rounds if n_rounds is not None else sc.n_rounds,
            eval_every if eval_every is not None else sc.eval_every)
    summary = summarize_history(sch.history)
    summary["scenario"] = sc.name
    summary["notes"] = sc.notes
    summary["events_applied"] = sch.events_applied
    summary["capacity"] = sc.capacity
    summary["clients_end"] = len(sch.clients)
    return sch, summary
