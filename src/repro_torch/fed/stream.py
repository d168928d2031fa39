"""Streaming participation: an event queue driving spans of rounds.

Counterpart of ``repro/fed/stream.py``'s ``StreamScheduler`` (the tiered
bank, prefetch, fault injection and telemetry wait for later slices).  At
each span start the scheduler pops every queued event with tau <= now,
applies it to the FedState and executes the slot actions it returns
against the RoundEngine (consecutive admits land as one ``admit_many``
burst; evicts and trace writes in order); then it runs rounds until the
next event tau, burst expiry or eval round, whichever is first.  Events
are applied at the first span boundary with tau >= event.tau.

mode="device" (the reference's default) draws participation and batches
on the device from the state's key (``RoundEngine.run_span(key=...)``);
mode="plan" samples them on the host with the numpy RNG in the seed draw
order, sample-for-sample the reference's plan mode.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.arrivals import RebootState
from repro_torch.core.departures import BoundTerms
from repro_torch.fed.driver import Client, RoundRecord
from repro_torch.fed.engine import RoundEngine
from repro_torch.fed.events import ParticipationEvent
from repro_torch.fed.state import FedState


class StreamScheduler:
    """Consumes a stream of ParticipationEvents while driving
    RoundEngine.run_span over the event-free gaps, with participation and
    batch indices drawn on the device (``mode="device"``) or sampled on
    the host in the seed draw order (``mode="plan"``).

    ``evaluate()`` (optional) returns (loss, acc) for the current params;
    it runs on the last round of a span that ends on an eval round, and
    rounds without an eval record NaN.  With the engine's
    ``with_metrics``, ``delta_norms`` holds each round's delta norm.
    """

    def __init__(self, *, clients: Sequence[Client], init_params,
                 engine: RoundEngine, mode: str = "device",
                 reboot_boost: float = 3.0, fast_reboot: bool = True,
                 horizon: Optional[int] = None,
                 bound_terms: Optional[BoundTerms] = None, seed: int = 0,
                 rng: Optional[np.random.Generator] = None, key=None,
                 evaluate: Optional[Callable] = None,
                 history: Optional[List[RoundRecord]] = None,
                 reboots: Optional[List[RebootState]] = None,
                 objective: Optional[set] = None,
                 events: Sequence[ParticipationEvent] = ()):
        if mode not in ("device", "plan"):
            raise ValueError(f"mode must be device|plan, got {mode!r}")
        self.mode = mode
        self.engine = engine
        self.E = engine.E
        self.B = engine.B
        self.params = init_params
        self._evaluate = evaluate
        self.state = FedState(
            clients=list(clients), capacity=engine.capacity,
            reboot_boost=reboot_boost, fast_reboot=fast_reboot,
            horizon=horizon, bound_terms=bound_terms, local_epochs=engine.E,
            seed=seed, rng=rng, key=key, objective=objective,
            reboots=reboots)
        self.history: List[RoundRecord] = (history if history is not None
                                           else [])
        self.delta_norms: List[float] = []
        self._span_args = None
        self._dirty = True
        self.push(*events)

    @property
    def lr_shift_tau(self) -> int:
        return self.state.lr_shift_tau

    def push(self, *events: ParticipationEvent) -> None:
        """Enqueue participation events (any order, any time, including
        between run() calls)."""
        self.state.push(*events)

    # -- event application (executes FedState transitions on the engine) -----
    def _apply_events(self, tau: int) -> str:
        st = self.state
        ev = ""
        admits = []     # consecutive admits land as one burst
        while st.due(tau):
            s, actions = st.apply(st.pop_event(), tau)
            for act in actions:
                if act[0] == "admit":
                    admits.append((act[1], st.clients[act[2]]))
                    continue
                self.engine.admit_many(admits)
                admits.clear()
                if act[0] == "evict":
                    self.engine.evict(act[1])
                else:                           # ("set_trace", slot, trace)
                    self.engine.set_trace(act[1], act[2])
            ev += s
            st.events_applied += 1
        self.engine.admit_many(admits)
        # a burst expiring here resumes its cohort: the active mask is
        # stale
        if st.expire(tau) or ev:
            self._dirty = True
        return ev

    def evaluate(self):
        if self._evaluate is None:
            return float("nan"), float("nan")
        return self._evaluate(self.params)

    def _args(self, tau: int) -> dict:
        """The span arguments on the engine's device, recomputed only when
        an event or a burst expiry dirtied them."""
        if self._span_args is None or self._dirty:
            dev = self.engine.device
            a = self.state.span_args(tau)
            self._span_args = dict(
                p=torch.as_tensor(a["p"], device=dev),
                active=torch.as_tensor(a["active"], device=dev),
                lr_shift_tau=a["lr_shift_tau"],
                reboot_tau0=torch.as_tensor(a["reboot_tau0"], device=dev),
                reboot_boost=torch.as_tensor(a["reboot_boost"], device=dev))
            self._dirty = False
        return self._span_args

    # -- main loop ------------------------------------------------------------
    def run(self, n_rounds: int, eval_every: int = 1):
        eng = self.engine
        st = self.state
        start = st.next_tau
        stop = start + n_rounds
        tau = start
        # per-span metrics stay on the device and are read back once,
        # after the loop: an evaluate() is the only sync inside it
        pending = []      # (tau, end, ev_label, device metrics, eval)
        try:
            while tau < stop:
                ev = self._apply_events(tau)
                end = st.span_end(tau, stop, ev, eval_every)
                args = self._args(tau)
                if self.mode == "device":
                    # the base key is never split: round tau folds tau in,
                    # so the draws do not depend on the span structure
                    self.params, m = eng.run_span(
                        self.params, tau, end - tau, key=st.key, **args)
                else:
                    plans = [st.sample_plan(t, self.E, self.B)
                             for t in range(tau, end)]
                    self.params, m = eng.run_span(
                        self.params, tau, end - tau,
                        plan=(np.stack([pl[0] for pl in plans]),
                              np.stack([pl[1] for pl in plans])), **args)
                eval_last = (end - 1) % eval_every == 0 or (
                    ev and end - tau == 1)
                pending.append((tau, end, ev, m,
                                self.evaluate() if eval_last else None))
                tau = end
            st.next_tau = stop
        finally:
            # spans that ran are recorded even if a later one raised
            self._flush_spans(pending)
        return self.history

    def _flush_spans(self, pending) -> None:
        """Device metrics -> host RoundRecords, in span order, with one
        read-back for all spans."""
        if not pending:
            return
        metrics = [m for _, _, _, m, _ in pending]
        s_all = torch.cat([m["s"] for m in metrics]).cpu().numpy()
        eta_all = torch.cat([m["eta"] for m in metrics]).cpu()
        if self.engine.with_metrics:
            self.delta_norms.extend(
                torch.cat([m["delta_norm"] for m in metrics]).tolist())
        row = 0
        for tau, end, ev, _, ev_result in pending:
            for t in range(tau, end):
                loss = acc = float("nan")
                if ev_result is not None and t == end - 1:
                    loss, acc = ev_result
                s = s_all[row]
                self.history.append(RoundRecord(
                    t, float(loss), float(acc), float(eta_all[row]),
                    int((s > 0).sum()), s, ev if t == tau else ""))
                row += 1
